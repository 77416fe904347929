"""Weight interchange: the ``.mat`` MLP importer and exporter and the
torch-pickle importer (a port-own copy of ``koopmanx/lifts/io.py``).

The ``.mat`` schema is ``W1..Wk`` with shape (out, in) and ``b1..bk``
with shape (1, out), as the reference's exports and the in-repo
``artifacts/*.mat`` hold them. The reference's full-model checkpoints
(``AutoEncoder_*.pkl``, ``torch.save(model)`` of a module with
``Encoder`` / ``Decoder`` ``nn.Sequential`` children) and
``torch.save(model.state_dict())`` files are read at the storage level:
the zip's ``data.pkl`` is unpickled with every class it names replaced by
an inert stand-in, and each tensor is rebuilt from its ``data/<key>``
record with numpy. ``torch.load`` is never called, and nothing the
checkpoint names is run.
"""
from __future__ import annotations

import builtins
import collections
import io
import pickle
import zipfile
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

MLPParams = List[Tuple[Tensor, Tensor]]


def load_mat_mlp(path: str, dtype: torch.dtype = torch.float32
                 ) -> List[Tuple[Tensor, Tensor]]:
    """Load ``W1..Wk / b1..bk`` MLP weights from a ``.mat`` file as
    ``[(W (out, in), b (out,)), ...]`` on the CPU, read through float64."""
    import scipy.io as sio

    data = sio.loadmat(path)
    params = []
    i = 1
    while f"W{i}" in data:
        w = np.asarray(data[f"W{i}"], dtype=np.float64)
        b = np.asarray(data[f"b{i}"], dtype=np.float64).reshape(-1)
        params.append((torch.tensor(w, dtype=dtype),
                       torch.tensor(b, dtype=dtype)))
        i += 1
    if not params:
        raise ValueError(f"no W1..Wk keys found in {path}")
    return params


def save_mat_mlp(path: str, params: Sequence[Tuple[Tensor, Tensor]]) -> None:
    """Write ``[(W (out, in), b (out,)), ...]`` in the same schema: ``W{i}``
    (out, in) and ``b{i}`` (1, out), in the tensors' own dtype."""
    import scipy.io as sio

    out = {}
    for i, (w, b) in enumerate(params, start=1):
        out[f"W{i}"] = w.detach().cpu().numpy()
        out[f"b{i}"] = b.detach().cpu().numpy().reshape(1, -1)
    sio.savemat(path, out)


# storage class name -> numpy dtype of its records
_STORAGE_DTYPES = {
    "FloatStorage": np.float32,
    "DoubleStorage": np.float64,
    "HalfStorage": np.float16,
    "LongStorage": np.int64,
    "IntStorage": np.int32,
    "ShortStorage": np.int16,
    "CharStorage": np.int8,
    "ByteStorage": np.uint8,
    "BoolStorage": np.bool_,
}
_BUILTINS = ("set", "frozenset", "dict", "list", "tuple", "complex",
             "bytearray", "slice", "range")


class _Stub:
    """Inert stand-in for every class a checkpoint names (``nn.Module``
    subclasses, activations, the training script's own classes): it
    records its arguments and state and runs nothing. A pickled module is
    its ``__dict__`` state, which is all the walk below needs."""

    def __init__(self, *args, **kwargs):
        self.__dict__["_args"] = args
        self.__dict__.update(kwargs)

    def __setstate__(self, state):
        if isinstance(state, dict):
            self.__dict__.update(state)
        else:
            self.__dict__["_state"] = state


def _rebuild_tensor_v2(storage, offset, size, stride, *_):
    """``torch._utils._rebuild_tensor_v2`` over a numpy storage: a strided
    view into the flat record, copied."""
    flat = storage
    if not size:
        return np.array(flat[offset])
    view = np.lib.stride_tricks.as_strided(
        flat[offset:], shape=tuple(size),
        strides=tuple(s * flat.itemsize for s in stride))
    return np.array(view)


def _rebuild_parameter(data, *_):
    return data


_REBUILD = {"_rebuild_tensor_v2": _rebuild_tensor_v2,
            "_rebuild_parameter": _rebuild_parameter}


class _StorageUnpickler(pickle.Unpickler):
    """Unpickles a torch zip checkpoint's ``data.pkl`` without torch's own
    unpickler: the tensor rebuild functions become numpy ones, storage
    classes dtype markers, ``OrderedDict`` and a few builtin containers
    themselves, and any other global an inert :class:`_Stub` subclass;
    each storage is read from the zip's ``data/<key>`` record."""

    def __init__(self, file, read_record):
        super().__init__(file)
        self._read_record = read_record

    def find_class(self, module, name):
        if module == "torch._utils" and name in _REBUILD:
            return _REBUILD[name]
        if module == "torch" and name in _STORAGE_DTYPES:
            return _STORAGE_DTYPES[name]
        if module == "collections" and name == "OrderedDict":
            return collections.OrderedDict
        if module in ("builtins", "__builtin__") and name in _BUILTINS:
            return getattr(builtins, name)
        return type(name, (_Stub,), {"__module__": module})

    def persistent_load(self, pid):
        # ('storage', storage class (here its dtype marker), key,
        # location, numel)
        if not (isinstance(pid, tuple) and pid and pid[0] == "storage"):
            raise pickle.UnpicklingError(f"unknown persistent id {pid!r}")
        _, dtype, key, _location, numel = pid
        if not (isinstance(dtype, type) and issubclass(dtype, np.generic)):
            dtype = np.float32  # a storage class not listed: float
        raw = self._read_record(str(key))
        return np.frombuffer(raw, dtype=dtype, count=int(numel))


def _walk_parameters(obj, prefix: str = "") -> Dict[str, np.ndarray]:
    """A stubbed ``nn.Module`` tree as a ``state_dict``-style mapping:
    the module keeps its children in ``_modules`` and its tensors in
    ``_parameters`` and ``_buffers``."""
    out = {}
    d = getattr(obj, "__dict__", {})
    for store in ("_parameters", "_buffers"):
        for name, val in (d.get(store) or {}).items():
            if val is not None:
                out[prefix + name] = np.asarray(val)
    for name, child in (d.get("_modules") or {}).items():
        if child is not None:
            out.update(_walk_parameters(child, prefix + name + "."))
    return out


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A torch zip checkpoint (``torch.save(model)`` or
    ``torch.save(model.state_dict())``) as ``{name: np.ndarray}``, read at
    the storage level (``koopmanx/lifts/io.py:162-181``)."""
    with zipfile.ZipFile(path) as zf:
        pkl_name = next(n for n in zf.namelist() if n.endswith("/data.pkl"))
        root = pkl_name[: -len("data.pkl")]
        with zf.open(pkl_name) as f:
            obj = _StorageUnpickler(
                io.BytesIO(f.read()),
                lambda key: zf.read(f"{root}data/{key}")).load()
    if isinstance(obj, dict):  # a state_dict
        return {k: np.asarray(v) for k, v in obj.items() if v is not None}
    return _walk_parameters(obj)


def load_torch_autoencoder(path: str, dtype: torch.dtype = torch.float32
                           ) -> Tuple[MLPParams, MLPParams]:
    """(encoder, decoder) weights of a reference full-model checkpoint
    (``koopmanx/lifts/io.py:184-209``): the ``Encoder.<i>`` and
    ``Decoder.<i>`` linear layers in index order, each ``(W (out, in),
    b (out,))`` on the CPU, read through float64 as the ``.mat`` loader."""
    state = load_torch_state_dict(path)
    enc, dec = [], []
    keys = sorted((k for k in state if k.endswith(".weight")),
                  key=lambda k: (k.split(".")[0], int(k.split(".")[1])))
    for key in keys:
        prefix = key[: -len(".weight")]
        w = np.asarray(state[key], dtype=np.float64)
        b = np.asarray(state[prefix + ".bias"], dtype=np.float64).reshape(-1)
        pair = (torch.tensor(w, dtype=dtype), torch.tensor(b, dtype=dtype))
        (enc if key.startswith("Encoder") else dec).append(pair)
    return enc, dec
