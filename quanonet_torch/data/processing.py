"""
Encoders: (u0, u) function pairs -> model-ready arrays (the port's own
copy of quanonet_tpu/data/processing.py).

The emitted arrays are byte-identical to the reference's
(data_utils/data_processing.py:10-123), which pins the RNG draw order (one
``np.random.choice(n, k, replace=False)`` per function, all train
functions first, then all test functions, against the global NumPy RNG)
and the row layout (point-major within each function, trunk coordinates
in 'ij' meshgrid order for PDE grids).

* ode_encode / pde_encode: (branch, trunk, output) triples with
  per-function random point subsampling (without replacement);
* ode_fncode / pde_fncode: FNO grid format (N, pts[, pts], channels).
"""
import numpy as np
from scipy import interpolate


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


def _with_coords(v, *grids):
    """Stack (N, P) values with per-point coordinate channels ->
    (N, P, 1 + len(grids)) float32."""
    n = v.shape[0]
    chans = [v] + [np.broadcast_to(g, (n, g.size)) for g in grids]
    return np.stack(chans, axis=2).astype(np.float32)


def ode_fncode(generate_data, num_train, num_test, num_points, num_cal=None):
    """FNO 1-D grid encoding: input (N, pts, 2) = (u0, x)
    (reference :45-81)."""
    train_v, train_u, test_v, test_u, _ = generate_data(
        num_train, num_test, num_points, num_points, num_cal=num_cal)

    if train_v.shape[1] != num_points:
        # u0 sampled on a coarser grid: resample linearly onto the
        # solution grid so input/output channels align
        x_old = np.linspace(0, 1, train_v.shape[1])
        x_new = np.linspace(0, 1, num_points)
        train_v = interpolate.interp1d(x_old, train_v, axis=1,
                                       kind='linear')(x_new)
        test_v = interpolate.interp1d(x_old, test_v, axis=1,
                                      kind='linear')(x_new)

    x_grid = np.linspace(0, 1, num_points).astype(np.float32)
    return (_with_coords(train_v, x_grid), None,
            train_u[:, :, None].astype(np.float32),
            _with_coords(test_v, x_grid), None,
            test_u[:, :, None].astype(np.float32))


def pde_fncode(generate_data, num_train, num_test, num_points, num_cal=None):
    """FNO 2-D -> flattened-1-D encoding: input (N, pts^2, 3) =
    (u0 broadcast over t, x, t) (reference :126-163)."""
    train_v, train_u, test_v, test_u, x, t = generate_data(
        num_train, num_test, num_points, num_points, num_cal=num_cal)

    X, T = np.meshgrid(x, t, indexing='ij')
    total = num_points * num_points

    def flat_v(v):
        # u0(x) broadcast along the t axis, then 'ij'-flattened to
        # match the coordinate channels
        return np.repeat(v[:, :, None], num_points, axis=2).reshape(
            v.shape[0], total)

    return (_with_coords(flat_v(train_v), X.ravel(), T.ravel()), None,
            train_u.reshape(-1, total, 1).astype(np.float32),
            _with_coords(flat_v(test_v), X.ravel(), T.ravel()), None,
            test_u.reshape(-1, total, 1).astype(np.float32))
