"""
The circuit's own work, counted from its gates, and the card's peaks.

The count does not depend on how the program computes the circuit, so a
new algorithm never makes it stale.  Each gate costs its standard
statevector price per amplitude of the 2^n-amplitude state:

    Hadamard           4 flops per amplitude
    real rotation      6 flops per amplitude (RY, applied pairwise)
    diagonal phase     6 flops per amplitude (RZ, the input phase)
    CNOT               0 (a permutation)

A block holds n Hadamards, one input phase and ``ld`` sublayers of 3n
rotations and a CNOT ring.  The sines and cosines are not counted.  A
backward pass costs twice the forward, so a training step is 3 passes.

Bytes are the circuit's own inputs and outputs: the angles, the weights
and the expectation (forward), and the expectation's cotangent, the angles,
the weights and their cotangents (backward), in fp32.
"""

# One H100 SXM (NVIDIA's data sheet, dense rates, 700 W).  An exact fp32
# product on the tensor cores takes 3 TF32 passes, the fastest exact route
# the program takes (the fused-group chain kernels): 495 / 3 TFLOP/s.
PEAK_FLOPS = 495e12 / 3
PEAK_FP32_SIMT_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

FLOPS_HADAMARD = 4
FLOPS_ROTATION = 6
FLOPS_PHASE = 6
FLOPS_CNOT = 0
BYTES_FP32 = 4


def block_lds(config):
    """The sublayer count of each block, in circuit order (the trunk's
    blocks, then the branch's) of a QuanONet ``config``."""
    bd, bld, td, tld = config['net_size']
    return [tld] * td + [bld] * bd


def forward_flops_per_row(n_qubits, lds):
    """Flops of one row's forward pass through blocks of ``lds``."""
    dim = 2 ** n_qubits
    total = 0
    for ld in lds:
        total += n_qubits * FLOPS_HADAMARD + FLOPS_PHASE
        total += ld * (3 * n_qubits * FLOPS_ROTATION
                       + n_qubits * FLOPS_CNOT)
    return total * dim


def circuit_work(config, rows, train):
    """(flops, bytes) of the circuit over ``rows`` rows: a forward pass, or
    with ``train`` a forward and a backward pass."""
    n = config['num_qubits']
    lds = block_lds(config)
    angles = rows * n * len(lds)
    weights = 3 * n * sum(lds)
    fwd_flops = forward_flops_per_row(n, lds) * rows
    fwd_bytes = angles + weights + rows
    if not train:
        return fwd_flops, fwd_bytes * BYTES_FP32
    bwd_bytes = rows + 2 * angles + 2 * weights
    return 3 * fwd_flops, (fwd_bytes + bwd_bytes) * BYTES_FP32


def least_seconds(flops, nbytes):
    """The least time the card could take for the work: the larger of its
    operations over the peak rate and its bytes over the bandwidth."""
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
