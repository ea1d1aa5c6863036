"""
Checkpoint reading and writing (the port's own copy of
quanonet_tpu/checkpoint.py; pure NumPy).

Two on-disk formats, both reference-compatible:

* ``.npz`` — named numpy arrays using the reference's MindSpore parameter
  names.
* ``.ckpt`` — MindSpore protobuf, parsed with a small wire-format reader.
  Message layout: repeated field 1 { field 1: param name (string);
  field 2: tensor { repeated field 1: dims (varint, 0 encodes a scalar);
  field 2: dtype (string, e.g. "Float32"); field 3: raw little-endian
  data } }.

Key schema:
    bias                              ()           scalar output bias
    QuanONet.weight / HEAQNN.weight  (S*3*nq,)     flat ansatz, sublayer-major
    branch_LinearLayer.Net2.weights  (bd*nq,)      TF affine (QuanONet)
    branch_LinearLayer.Net2.bias     (bd*nq,)
    trunk_LinearLayer.Net2.weights   (td*nq,)
    trunk_LinearLayer.Net2.bias      (td*nq,)
    LinearLayer.Net2.weights/bias    (d*nq,)       TF affine (HEAQNN)

The flat ansatz reshapes to (total_sublayers, 3, nq): circuit order —
trunk sublayers first, per sublayer [RY, RZ, RY'] gate-major.
"""
import os

import numpy as np

_DTYPES = {
    'Float32': np.float32, 'Float16': np.float16, 'Float64': np.float64,
    'Int32': np.int32, 'Int64': np.int64, 'BFloat16': np.float32,
}


# ── MindSpore .ckpt protobuf reader ──────────────────────────────────────────

def _read_varint(buf, pos):
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7


def _read_tag(buf, pos):
    key, pos = _read_varint(buf, pos)
    return key >> 3, key & 0x7, pos


def _parse_tensor(buf):
    """Inner tensor message -> numpy array."""
    pos = 0
    dims = []
    dtype = np.float32
    data = b''
    while pos < len(buf):
        field, wire, pos = _read_tag(buf, pos)
        if field == 1 and wire == 0:          # dim (varint)
            v, pos = _read_varint(buf, pos)
            dims.append(v)
        elif field == 1 and wire == 2:        # packed dims
            ln, pos = _read_varint(buf, pos)
            end = pos + ln
            while pos < end:
                v, pos = _read_varint(buf, pos)
                dims.append(v)
        elif field == 2 and wire == 2:        # dtype string
            ln, pos = _read_varint(buf, pos)
            dtype = _DTYPES.get(buf[pos:pos + ln].decode(), np.float32)
            pos += ln
        elif field == 3 and wire == 2:        # raw data
            ln, pos = _read_varint(buf, pos)
            data = buf[pos:pos + ln]
            pos += ln
        else:                                  # skip unknown
            if wire == 0:
                _, pos = _read_varint(buf, pos)
            elif wire == 2:
                ln, pos = _read_varint(buf, pos)
                pos += ln
            elif wire == 5:
                pos += 4
            elif wire == 1:
                pos += 8
            else:
                raise ValueError(f"unsupported wire type {wire}")
    arr = np.frombuffer(data, dtype=dtype)
    # MindSpore encodes scalars as dims=[0]
    shape = () if dims == [0] else tuple(dims)
    return arr.reshape(shape)


def load_ms_ckpt(path) -> dict:
    """Parse a MindSpore .ckpt file into {param_name: np.ndarray}."""
    with open(path, 'rb') as fh:
        buf = fh.read()
    pos = 0
    params = {}
    while pos < len(buf):
        field, wire, pos = _read_tag(buf, pos)
        if field != 1 or wire != 2:
            raise ValueError(f"unexpected top-level field {field}/{wire} "
                             f"at byte {pos} of {path}")
        ln, pos = _read_varint(buf, pos)
        entry = buf[pos:pos + ln]
        pos += ln
        # entry: field 1 = name, field 2 = tensor
        epos = 0
        name = None
        tensor = None
        while epos < len(entry):
            f, _, epos = _read_tag(entry, epos)
            ln2, epos = _read_varint(entry, epos)
            payload = entry[epos:epos + ln2]
            epos += ln2
            if f == 1:
                name = payload.decode()
            elif f == 2:
                tensor = _parse_tensor(payload)
        if name is not None and tensor is not None:
            params[name] = tensor
    return params


def _write_varint(value: int) -> bytes:
    out = bytearray()
    while True:
        b = value & 0x7F
        value >>= 7
        if value:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


_DTYPE_NAMES = {np.dtype(np.float32): 'Float32',
                np.dtype(np.float64): 'Float64',
                np.dtype(np.float16): 'Float16',
                np.dtype(np.int32): 'Int32',
                np.dtype(np.int64): 'Int64'}


def save_ms_ckpt(path, params: dict):
    """Write {name: array} as a MindSpore-compatible .ckpt (inverse of
    :func:`load_ms_ckpt`), atomically."""
    out = bytearray()
    for name, arr in params.items():
        arr = np.asarray(arr)      # (ascontiguousarray would make 0-d 1-d)
        dtype_name = _DTYPE_NAMES.get(arr.dtype)
        if dtype_name is None:
            arr = arr.astype(np.float32)
            dtype_name = 'Float32'
        # tensor message: dims (field 1), dtype (field 2), data (field 3)
        tensor = bytearray()
        dims = [0] if arr.shape == () else list(arr.shape)  # 0 encodes scalar
        for d in dims:
            tensor += b'\x08' + _write_varint(d)
        dt = dtype_name.encode()
        tensor += b'\x12' + _write_varint(len(dt)) + dt
        raw = arr.tobytes()
        tensor += b'\x1a' + _write_varint(len(raw)) + raw
        # entry: name (field 1), tensor (field 2)
        nm = name.encode()
        entry = (b'\x0a' + _write_varint(len(nm)) + nm
                 + b'\x12' + _write_varint(len(tensor)) + bytes(tensor))
        out += b'\x0a' + _write_varint(len(entry)) + entry
    tmp = path + '.tmp'
    with open(tmp, 'wb') as f:
        f.write(bytes(out))
    os.replace(tmp, path)


def save_npz(path, params, model_type):
    """Write the reference-compatible .npz (atomic) of a {'params': ...}
    tree."""
    if model_type in ('QuanONet', 'HEAQNN'):
        raw = quantum_params_to_raw(params, model_type)
    else:
        raw = flatten_tree(params)
    tmp = path + '.tmp.npz'
    np.savez(tmp, **raw)
    os.replace(tmp, path)


def flatten_tree(params) -> dict:
    """Nested {'params': ...} tree -> flat {'a.b.c': array} dict."""
    out = {}
    p = params['params'] if 'params' in params else params

    def rec(node, pre):
        if isinstance(node, dict):
            for k, v in node.items():
                rec(v, pre + k + '.')
        else:
            out[pre[:-1]] = np.asarray(node)

    rec(p, '')
    return out


def unflatten_tree(raw: dict) -> dict:
    """Inverse of :func:`flatten_tree`."""
    tree = {}
    for key, val in raw.items():
        parts = key.split('.')
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = np.asarray(val)
    return {'params': tree}


# ── reference keys <-> parameter tree ────────────────────────────────────────

def load_raw(path) -> dict:
    """Load either format into {reference key: np.ndarray}."""
    if str(path).endswith('.ckpt'):
        return load_ms_ckpt(path)
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


def quantum_params_from_raw(raw: dict, model_type: str, net_size,
                            num_qubits: int, if_trainable_freq: bool) -> dict:
    """Reference checkpoint dict -> {'params': ...} tree (the JAX
    package's layout) for QuanONet / HEAQNN."""
    params = {}
    if model_type == 'QuanONet':
        bd, bld, td, tld = net_size
        total_sub = bd * bld + td * tld
        flat = np.asarray(raw['QuanONet.weight'], np.float32)
        if flat.size != total_sub * 3 * num_qubits:
            raise ValueError(
                f"QuanONet.weight has {flat.size} elements; expected "
                f"{total_sub * 3 * num_qubits} "
                f"({total_sub}x3x{num_qubits}) — check net_size/num_qubits")
        params['ansatz'] = flat.reshape(total_sub, 3, num_qubits)
        params['bias'] = np.asarray(raw['bias'], np.float32).reshape(())
        if if_trainable_freq:
            params['branch_freq'] = {
                'weights': np.asarray(raw['branch_LinearLayer.Net2.weights'],
                                      np.float32),
                'bias': np.asarray(raw['branch_LinearLayer.Net2.bias'],
                                   np.float32),
            }
            params['trunk_freq'] = {
                'weights': np.asarray(raw['trunk_LinearLayer.Net2.weights'],
                                      np.float32),
                'bias': np.asarray(raw['trunk_LinearLayer.Net2.bias'],
                                   np.float32),
            }
    elif model_type == 'HEAQNN':
        depth, ld = int(net_size[0]), int(net_size[1])
        total_sub = depth * ld
        flat = np.asarray(raw['HEAQNN.weight'], np.float32)
        if flat.size != total_sub * 3 * num_qubits:
            raise ValueError(
                f"HEAQNN.weight has {flat.size} elements; expected "
                f"{total_sub * 3 * num_qubits}")
        params['ansatz'] = flat.reshape(total_sub, 3, num_qubits)
        if if_trainable_freq:
            params['freq'] = {
                'weights': np.asarray(raw['LinearLayer.Net2.weights'],
                                      np.float32),
                'bias': np.asarray(raw['LinearLayer.Net2.bias'], np.float32),
            }
    else:
        raise ValueError(f"not a quantum model: {model_type}")
    return {'params': params}


def quantum_params_to_raw(params: dict, model_type: str) -> dict:
    """{'params': ...} tree -> reference key schema."""
    p = params['params'] if 'params' in params else params
    raw = {}
    ansatz = np.asarray(p['ansatz'], np.float32)
    if model_type == 'QuanONet':
        raw['QuanONet.weight'] = ansatz.reshape(-1)
        raw['bias'] = np.asarray(p['bias'], np.float32)
        if 'branch_freq' in p:
            raw['branch_LinearLayer.Net2.weights'] = np.asarray(
                p['branch_freq']['weights'], np.float32)
            raw['branch_LinearLayer.Net2.bias'] = np.asarray(
                p['branch_freq']['bias'], np.float32)
            raw['trunk_LinearLayer.Net2.weights'] = np.asarray(
                p['trunk_freq']['weights'], np.float32)
            raw['trunk_LinearLayer.Net2.bias'] = np.asarray(
                p['trunk_freq']['bias'], np.float32)
    elif model_type == 'HEAQNN':
        raw['HEAQNN.weight'] = ansatz.reshape(-1)
        if 'freq' in p:
            raw['LinearLayer.Net2.weights'] = np.asarray(
                p['freq']['weights'], np.float32)
            raw['LinearLayer.Net2.bias'] = np.asarray(
                p['freq']['bias'], np.float32)
    else:
        raise ValueError(f"not a quantum model: {model_type}")
    return raw
