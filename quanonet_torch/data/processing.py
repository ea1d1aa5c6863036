"""
Encoders: (u0, u) function pairs -> model-ready arrays (the port's own
copy of quanonet_tpu/data/processing.py, operator encodings only; the FNO
grid encodings come with the classical models, ROADMAP §A7).

The emitted arrays are byte-identical to the reference's
(data_utils/data_processing.py:10-123), which pins the RNG draw order (one
``np.random.choice(n, k, replace=False)`` per function, all train
functions first, then all test functions, against the global NumPy RNG)
and the row layout (point-major within each function, trunk coordinates
in 'ij' meshgrid order for PDE grids).
"""
import numpy as np


def _draw_point_subsets(n_fns, n_pts, k):
    """(n_fns, k) int indices; one sequential global-RNG choice() per
    function — the draw order IS the cache contract, do not vectorize."""
    return np.stack([np.random.choice(n_pts, k, replace=False)
                     for _ in range(n_fns)])


def _encode(u0, u, coords, sample_num):
    """One split (train or test): each function contributes
    ``sample_num`` rows of (its u0, a sampled coordinate, the solution
    there)."""
    n_fns = u0.shape[0]
    idx = _draw_point_subsets(n_fns, coords.shape[0], sample_num)
    vals = np.take_along_axis(u.reshape(n_fns, -1), idx, axis=1)
    return (np.repeat(u0, sample_num, axis=0),
            coords[idx.ravel()],
            vals.reshape(-1, 1))


def ode_encode(generate_data, num_train, num_test, num_points, num_points_0,
               train_sample_num, test_sample_num, num_cal=None):
    """1-D operators: trunk coordinate = x (reference :10-43)."""
    u0_train, u_train, u0_test, u_test, x = generate_data(
        num_train, num_test, num_points, num_points_0, num_cal=num_cal)
    coords = x.reshape(-1, 1)
    tr = _encode(u0_train, u_train, coords, train_sample_num)
    te = _encode(u0_test, u_test, coords, test_sample_num)
    return (*tr, *te)


def pde_encode(generate_data, num_train, num_test, num_points, num_points_0,
               train_sample_num, test_sample_num, num_cal=None):
    """2-D operators: trunk coordinate = (x, t), 'ij' grid order
    (reference :83-123)."""
    u0_train, u_train, u0_test, u_test, x, t = generate_data(
        num_train, num_test, num_points, num_points_0, num_cal=num_cal)
    X, T = np.meshgrid(x, t, indexing='ij')
    coords = np.column_stack((X.ravel(), T.ravel()))
    tr = _encode(u0_train, u_train, coords, train_sample_num)
    te = _encode(u0_test, u_test, coords, test_sample_num)
    return (*tr, *te)
