"""Static-graph AMP: program rewrite to bf16 and dynamic loss scaling
(counterpart of ``paddle_tpu/amp/static_amp.py``).

Reference: python/paddle/fluid/contrib/mixed_precision/decorator.py
``decorate:253`` + fp16_utils.py rewrite the program per black/white op
lists and add dynamic loss-scaling ops.  The rewrite is the registered
``amp_bf16`` and ``prune_redundant_casts`` passes (fluid/passes/amp.py);
loss scaling is optional for bf16 (float32's exponent range) and the
``check_finite_and_unscale`` / ``update_loss_scaling`` pair
(ops/optimizer_ops.py) is appended when a scale other than 1 or dynamic
scaling is asked for.

``decorate``'s four scaling arguments reach ``update_loss_scaling`` as
its attrs.  The reference's ``decorate`` drops them and appends the op
with no attrs, so there the op's defaults hold (1000, 2, 2.0 and 0.5,
where ``decorate`` says ``decr_ratio=0.8``); the two agree at
``decr_ratio=0.5`` and the other defaults.
"""
from __future__ import annotations

from ..fluid.framework import Program
from ..fluid import layers
from .lists import WHITE_OPS, BLACK_OPS


class CustomOpLists:
    def __init__(self, custom_white_list=None, custom_black_list=None):
        self.custom_white_list = set(custom_white_list or ())
        self.custom_black_list = set(custom_black_list or ())
        self.white_list = set(WHITE_OPS) | self.custom_white_list
        self.black_list = set(BLACK_OPS) | self.custom_black_list


AutoMixedPrecisionLists = CustomOpLists


def rewrite_program_bf16(program: Program, amp_lists: CustomOpLists = None,
                         dtype: str = "bfloat16", targets=(),
                         prune_casts: bool = True):
    """Rewrite ``program`` to ``dtype`` mixed precision through the
    registered IR passes: ``amp_bf16`` cast insertion (grad halves
    included) plus the ``prune_redundant_casts`` cleanup."""
    amp_lists = amp_lists or CustomOpLists()
    from ..fluid.passes import PassPipeline, create_pass
    # hand the pass only the CUSTOM deltas (including any post-construction
    # mutation of .white_list/.black_list): the pass lets a custom white
    # entry pull an op out of the default black list, which feeding the
    # full unioned black_list back as "custom" would defeat
    white = (amp_lists.white_list - WHITE_OPS) \
        | getattr(amp_lists, "custom_white_list", set())
    black = (amp_lists.black_list - BLACK_OPS) \
        | getattr(amp_lists, "custom_black_list", set())
    plist = [create_pass("amp_bf16", dtype=dtype,
                         custom_white_list=white,
                         custom_black_list=black)]
    if prune_casts:
        plist.append(create_pass("prune_redundant_casts"))
    PassPipeline(plist).apply(program, targets=targets)
    return program


class OptimizerWithMixedPrecision:
    """decorator.py:30 analog: wraps an optimizer; ``minimize`` rewrites
    the program to bf16 and adds loss scaling."""

    def __init__(self, optimizer, amp_lists=None, init_loss_scaling=1.0,
                 use_dynamic_loss_scaling=False, dtype="bfloat16",
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.8):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or CustomOpLists()
        self._init_scale = init_loss_scaling
        self._dynamic = use_dynamic_loss_scaling
        self._dtype = dtype
        self._scaling_attrs = {
            "incr_every_n_steps": incr_every_n_steps,
            "decr_every_n_nan_or_inf": decr_every_n_nan_or_inf,
            "incr_ratio": incr_ratio, "decr_ratio": decr_ratio}
        self._loss_scaling = None

    def get_loss_scaling(self):
        return self._loss_scaling

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        program = loss.block.program
        # keep the inserted casts as real ops here: backward has not run
        # yet, and append_backward must differentiate through them; the
        # cleanup pass runs below, after the grad, loss-scaling and update
        # ops all exist
        rewrite_program_bf16(program, self._amp_lists, self._dtype,
                             targets=[loss.name], prune_casts=False)

        scaled_loss = loss
        if self._init_scale != 1.0 or self._dynamic:
            self._loss_scaling = layers.create_global_var(
                [1], self._init_scale, "float32", persistable=True,
                name="loss_scaling")
            scaled_loss = layers.elementwise_mul(loss, self._loss_scaling)

        params_grads = self._optimizer.backward(
            scaled_loss, startup_program, parameter_list, no_grad_set)

        if self._loss_scaling is not None:
            grads = [g for _, g in params_grads]
            from ..fluid.layer_helper import LayerHelper
            helper = LayerHelper("check_finite_and_unscale")
            found_inf = helper.create_variable_for_type_inference(
                dtype="bool", stop_gradient=True)
            helper.append_op(
                "check_finite_and_unscale",
                inputs={"X": grads, "Scale": [self._loss_scaling]},
                outputs={"Out": grads, "FoundInfinite": [found_inf]})
            if self._dynamic:
                good = layers.create_global_var([1], 0, "int32",
                                                persistable=True,
                                                name="good_steps")
                bad = layers.create_global_var([1], 0, "int32",
                                               persistable=True,
                                               name="bad_steps")
                helper.append_op(
                    "update_loss_scaling",
                    inputs={"X": grads, "FoundInfinite": [found_inf],
                            "PrevLossScaling": [self._loss_scaling],
                            "InGoodSteps": [good], "InBadSteps": [bad]},
                    outputs={"Out": grads,
                             "LossScaling": [self._loss_scaling],
                             "OutGoodSteps": [good], "OutBadSteps": [bad]},
                    attrs=dict(self._scaling_attrs))
        ops = self._optimizer.apply_gradients(params_grads)
        # now that forward, grads, and updates all exist, clean up: the
        # fold rewires forward ops and their grad mirrors consistently
        from ..fluid.passes import PassPipeline, create_pass
        PassPipeline([create_pass("prune_redundant_casts")]).apply(
            program, targets=[loss.name, scaled_loss.name])
        return ops, params_grads

    def backward(self, loss, **kw):
        return self._optimizer.backward(loss, **kw)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)


def decorate(optimizer, amp_lists=None, init_loss_scaling=1.0,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=False, dtype="bfloat16"):
    """contrib.mixed_precision.decorate analog (bf16 defaults); the
    scaling arguments reach ``update_loss_scaling``."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling, use_dynamic_loss_scaling,
        dtype, incr_every_n_steps, decr_every_n_nan_or_inf, incr_ratio,
        decr_ratio)
