"""``save_dygraph`` and ``load_dygraph`` (counterpart of
``paddle_tpu/dygraph/checkpoint.py``; reference
python/paddle/fluid/dygraph/checkpoint.py).

A state dict is pickled as a dict of numpy arrays into ``<path>.pdparams``;
``load_dygraph`` also reads ``<path>.pdopt`` where there is one.  The
file holds the same objects as the reference's, so either package loads
the other's.  A bfloat16 tensor has no numpy dtype: saving one raises
``TypeError``, as ``fluid.io`` does (the reference writes raw ``|V2``
bytes that it cannot load back).
"""
from __future__ import annotations

import os
import pickle

import numpy as np
import torch


def _host_array(v):
    if hasattr(v, "_value"):            # a VarBase or ParamBase
        v = v._value
    if isinstance(v, torch.Tensor):
        if v.dtype == torch.bfloat16:
            raise TypeError("save_dygraph: a bfloat16 tensor has no numpy "
                            "dtype to save as; cast it to float32 first")
        return v.detach().cpu().numpy()
    return np.asarray(v)


def save_dygraph(state_dict, model_path):
    """Pickle ``state_dict`` (VarBases, tensors or numpy arrays by name)
    into ``model_path + ".pdparams"``; returns the file's path."""
    out = {k: _host_array(v) for k, v in state_dict.items()}
    path = model_path if model_path.endswith(".pdparams") \
        else model_path + ".pdparams"
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(out, f)
    return path


def load_dygraph(model_path):
    """(parameters, optimizer state or None) from ``model_path`` (or
    ``model_path + ".pdparams"``) and ``model_path + ".pdopt"``."""
    path = model_path if os.path.exists(model_path) \
        else model_path + ".pdparams"
    with open(path, "rb") as f:
        params = pickle.load(f)
    opt = None
    opt_path = model_path + ".pdopt"
    if os.path.exists(opt_path):
        with open(opt_path, "rb") as f:
            opt = pickle.load(f)
    return params, opt
