"""Post-training quantization (counterpart of
``paddle_tpu/contrib/slim/quantization/post_training_quantization.py``).

Reference: python/paddle/fluid/contrib/slim/quantization/
post_training_quantization.py.  Calibration batches run through the
float program; each quantizable op's activation inputs and outputs are
fetched to the host, where their ranges accumulate (``abs_max``: the
largest |value|; otherwise a 2048-bin histogram of |value| cut where it
holds 99.99% of the mass).  The weights' scales are their per-channel
abs max over axis 0.  The program comes back with ``_quant_scales``, and
``save_quantized_model`` writes them as ``quant_scales.json``.
"""
from __future__ import annotations

import json
import os

import numpy as np

from .quantization_pass import QUANTIZABLE_OPS, _WEIGHT_SLOTS


def _host(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") \
        else np.asarray(v)


class PostTrainingQuantization:
    def __init__(self, executor, program, feed_list, fetch_list,
                 data_loader=None, batch_nums=10, algo="abs_max",
                 weight_bits=8, activation_bits=8,
                 quantizable_op_type=QUANTIZABLE_OPS, scope=None):
        self.exe = executor
        self.program = program
        self.feed_list = feed_list
        self.fetch_list = fetch_list
        self.loader = data_loader
        self.batch_nums = batch_nums
        self.algo = algo
        self.weight_bits = weight_bits
        self.activation_bits = activation_bits
        self.op_types = tuple(quantizable_op_type)
        self.scope = scope
        self._act_ranges = {}
        self._hists = {}

    # -- calibration ---------------------------------------------------------
    def _observe_vars(self):
        names = set()
        for op in self.program.global_block().ops:
            if op.type in self.op_types:
                for slot, vs in op.inputs.items():
                    if slot in ("X", "Input"):
                        names.update(vs)
                for vs in op.outputs.values():
                    names.update(vs)
        return sorted(names)

    def _update_ranges(self, name, arr):
        amax = float(np.abs(arr).max()) if arr.size else 0.0
        if self.algo == "abs_max":
            self._act_ranges[name] = max(self._act_ranges.get(name, 0.0),
                                         amax)
            return
        hist, edges = np.histogram(np.abs(arr), bins=2048,
                                   range=(0, max(amax, 1e-8)))
        prev = self._hists.get(name)
        if prev is None or prev[1][-1] < edges[-1]:
            if prev is not None:      # re-bin the old counts into the range
                old_centers = (prev[1][:-1] + prev[1][1:]) / 2
                add, _ = np.histogram(old_centers, bins=2048,
                                      range=(0, edges[-1]), weights=prev[0])
                hist = hist + add
            self._hists[name] = (hist.astype(np.float64), edges)
        else:
            add, _ = np.histogram(np.abs(arr), bins=2048,
                                  range=(0, prev[1][-1]))
            self._hists[name] = (prev[0] + add, prev[1])

    def _finalize_ranges(self):
        if self.algo == "abs_max":
            return dict(self._act_ranges)
        out = {}
        for name, (hist, edges) in self._hists.items():
            # the smallest range that keeps 99.99% of the mass
            c = np.cumsum(hist)
            if c[-1] <= 0:
                out[name] = float(edges[-1])
                continue
            idx = int(np.searchsorted(c, 0.9999 * c[-1]))
            out[name] = float(edges[min(idx + 1, len(edges) - 1)])
        return out

    def quantize(self):
        block = self.program.global_block()
        existing = sorted(v for v in self._observe_vars()
                          if block._find_var_recursive(v) is not None)
        n = 0
        for batch in self.loader():
            fetches = self.exe.run(self.program, feed=batch,
                                   fetch_list=existing)
            for name, arr in zip(existing, fetches):
                self._update_ranges(name, _host(arr))
            n += 1
            if n >= self.batch_nums:
                break
        act_scales = self._finalize_ranges()

        # weight scales straight from the parameter values
        from ....fluid import core
        scope = self.scope or core.global_scope()
        weight_scales = {}
        for op in block.ops:
            if op.type in self.op_types:
                for name in op.inputs.get(_WEIGHT_SLOTS.get(op.type), []):
                    w = scope.find_var(name)
                    if w is not None:
                        arr = _host(w)
                        axes = tuple(i for i in range(arr.ndim) if i != 0)
                        weight_scales[name] = np.abs(arr).max(
                            axis=axes if arr.ndim > 1 else None)
        self.program._quant_scales = {"activations": act_scales,
                                      "weights": weight_scales,
                                      "weight_bits": self.weight_bits,
                                      "activation_bits": self.activation_bits}
        return self.program

    def save_quantized_model(self, save_model_path, **kw):
        os.makedirs(save_model_path, exist_ok=True)
        meta = {
            "activations": self.program._quant_scales["activations"],
            "weights": {k: np.asarray(v).tolist() for k, v in
                        self.program._quant_scales["weights"].items()},
            "weight_bits": self.weight_bits,
            "activation_bits": self.activation_bits,
        }
        with open(os.path.join(save_model_path, "quant_scales.json"),
                  "w") as f:
            json.dump(meta, f)
        return save_model_path
