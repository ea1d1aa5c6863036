"""
Reads a MindSpore ``.ckpt`` (the format of the QuanONet paper's released
weights) into arrays by the reference model's leaf names.

The file is a protobuf: repeated field 1 { field 1: the parameter's name;
field 2: a tensor { field 1: dims (varint; [0] is a scalar), field 2: the
dtype's name, field 3: the raw little-endian data } }.
"""
import numpy as np

_DTYPES = {'Float32': np.float32, 'Float64': np.float64,
           'Float16': np.float16}

# the released file's names -> the reference's leaves
NAMES = {
    'bias': 'bias',
    'QuanONet.weight': 'ansatz',
    'branch_LinearLayer.Net2.weights': 'branch_freq.weights',
    'branch_LinearLayer.Net2.bias': 'branch_freq.bias',
    'trunk_LinearLayer.Net2.weights': 'trunk_freq.weights',
    'trunk_LinearLayer.Net2.bias': 'trunk_freq.bias',
}


def _varint(buf, pos):
    value, shift = 0, 0
    while True:
        byte = buf[pos]
        pos += 1
        value |= (byte & 0x7F) << shift
        if not byte & 0x80:
            return value, pos
        shift += 7


def _fields(buf):
    """(field number, wire type, payload) of each field of a message;
    a varint's payload is its value."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        field, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 2:
            size, pos = _varint(buf, pos)
            value, pos = buf[pos:pos + size], pos + size
        elif wire == 5:
            value, pos = buf[pos:pos + 4], pos + 4
        elif wire == 1:
            value, pos = buf[pos:pos + 8], pos + 8
        else:
            raise ValueError(f"wire type {wire} in a .ckpt")
        yield field, wire, value


def _tensor(buf):
    dims, dtype, data = [], np.float32, b''
    for field, wire, value in _fields(buf):
        if field == 1 and wire == 0:
            dims.append(value)
        elif field == 1 and wire == 2:          # packed dims
            pos = 0
            while pos < len(value):
                dim, pos = _varint(value, pos)
                dims.append(dim)
        elif field == 2:
            dtype = _DTYPES[bytes(value).decode()]
        elif field == 3:
            data = bytes(value)
    arr = np.frombuffer(data, dtype=dtype).astype(np.float32)
    return arr.reshape(() if dims == [0] else tuple(dims))


def read(path, n_qubits):
    """{leaf: float32 array} of a QuanONet .ckpt; the ansatz as
    (sublayers, 3, n_qubits)."""
    with open(path, 'rb') as fh:
        buf = fh.read()
    out = {}
    for field, _, entry in _fields(buf):
        if field != 1:
            continue
        name = tensor = None
        for f, _, value in _fields(entry):
            if f == 1:
                name = bytes(value).decode()
            elif f == 2:
                tensor = _tensor(value)
        if name in NAMES:
            out[NAMES[name]] = tensor
    out['ansatz'] = out['ansatz'].reshape(-1, 3, n_qubits)
    out['bias'] = out['bias'].reshape(())
    return out
