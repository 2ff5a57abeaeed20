"""hapi.Model: fit, evaluate and predict (counterpart of
``paddle_tpu/hapi/model.py``).  Both adapters, as in the reference:
under a dygraph tracer the network runs eagerly on the tape (forward,
loss, ``backward()``, ``step()``, ``clear_grad()``); in static mode a
``_StaticAdapter`` builds the train, eval and predict programs once from
the same network object and runs each batch through the ``Executor``
on the expected place (the card unless ``paddle.set_device`` named
another)."""
from __future__ import annotations

import contextlib

import numpy as np
import torch

from ..dygraph.base import to_variable, VarBase
from ..dygraph.layers import Layer
from ..fluid.framework import in_dygraph_mode, _current_expected_place
from . import callbacks as cb_mod


class Input:
    def __init__(self, shape=None, dtype="float32", name=None):
        self.shape = shape
        self.dtype = dtype
        self.name = name


class _StaticAdapter:
    """The network's parameters were made in the construction-time
    default program; each mode's program adopts them by name, the
    construction startup program (pruned to this network's variables)
    fills the scope, and batches run through the Executor."""

    def __init__(self, model: "Model"):
        from ..fluid import framework as fw
        self.model = model
        self._orig_main = fw.default_main_program()
        self._startup = fw.default_startup_program()
        self._progs = {}
        self._exe = None
        self._startup_done = False
        self._startup_nprogs = -1
        self._startup_ran = set()
        # the fit loader's batch sizes, stamped on the programs so the
        # executor's shape bucketing pads a ragged last batch
        self._bucket_edges = None
        # fit() submits train batches through the async window
        self._train_runner = None

    def _executor(self):
        if self._exe is None:
            from ..fluid.executor import Executor
            self._exe = Executor(_current_expected_place())
        return self._exe

    def _build(self, mode):
        if mode in self._progs:
            return self._progs[mode]
        from ..fluid.framework import Program, program_guard
        from ..fluid import layers as FL
        m = self.model
        in_specs = _as_list(m._inputs)
        lb_specs = _as_list(m._labels)
        if not in_specs:
            raise ValueError(
                "static-mode Model needs inputs=[hapi.Input(shape, dtype)] "
                "specs: shapes cannot be inferred without eager tensors")
        prog = Program()
        with program_guard(prog, self._startup):
            gb = prog.global_block()
            for p in self._orig_main.all_parameters():
                gb.vars[p.name] = p
            ins = [FL.data(s.name or f"hapi_x{i}", s.shape, dtype=s.dtype)
                   for i, s in enumerate(in_specs)]
            lbs = [FL.data(s.name or f"hapi_y{i}", s.shape, dtype=s.dtype)
                   for i, s in enumerate(lb_specs)]
            if mode == "train":
                m.network.train()
            else:
                m.network.eval()
            outs = _as_list(m.network(*ins))
            if mode == "predict":
                fetch = [o.name for o in outs]
            else:
                loss = m._loss(*outs, *lbs) if m._loss else outs[0]
                if loss.shape not in ((), (1,), None):
                    loss = FL.mean(loss)
                opt = None
                if mode == "train":
                    opt = _static_optimizer(m._optimizer)
                    opt.minimize(loss)
                fetch = [loss.name] + [o.name for o in outs]
        entry = {"prog": prog, "run_prog": prog,
                 "ins": [v.name for v in ins],
                 "lbs": [v.name for v in lbs], "fetch": fetch}
        if mode == "train":
            entry["optimizer"] = opt
        if mode == "train" and m._amp_level not in (None, "O0"):
            # amp_level O1 or O2: the train program goes through the
            # amp_bf16 and prune_redundant_casts passes at its first run;
            # the parameters stay float32 in the scope (the masters) and
            # the forward reads bf16 casts of them
            from ..fluid.compiler import BuildStrategy, CompiledProgram
            bs = BuildStrategy()
            bs.amp = True
            bs.amp_dtype = m._amp_dtype
            entry["run_prog"] = CompiledProgram(prog, build_strategy=bs)
        self._progs[mode] = entry
        return entry

    def _ensure_startup(self):
        """Run the startup ops of the variables the programs built so far
        need (the parameters at the first batch, the optimizer's state
        when the train program lands), pruned to this adapter's
        variables, and never over a value the scope already holds (a
        ``Model.load`` before the first batch)."""
        if self._startup_done and len(self._progs) == self._startup_nprogs:
            return
        import copy
        from ..fluid.core import global_scope
        names = set()
        for e in self._progs.values():
            names.update(e["prog"].global_block().vars.keys())
        scope = global_scope()
        done = self._startup_ran

        def key(op):
            return (op.type, tuple(sorted(op.output_arg_names)))

        sp = copy.deepcopy(self._startup)
        b = sp.global_block()
        todo = [op for op in b.ops
                if key(op) not in done
                and any(n in names for n in op.output_arg_names)
                and any(scope.find_var(n) is None
                        for n in op.output_arg_names)]
        if todo:
            b.ops = todo
            sp._bump_version()
            self._executor().run(sp)
            done.update(key(op) for op in todo)
        self._startup_done = True
        self._startup_nprogs = len(self._progs)

    def _prep(self, mode, inputs, labels):
        entry = self._build(mode)
        if self._bucket_edges:
            entry["prog"]._hints["bucket_edges"] = self._bucket_edges
        else:
            entry["prog"]._hints.pop("bucket_edges", None)
        self._ensure_startup()
        feed = {}
        for name, arr in zip(entry["ins"], _as_list(inputs)):
            feed[name] = np.asarray(arr)
        for name, arr in zip(entry["lbs"], _as_list(labels)):
            feed[name] = np.asarray(arr)
        return entry, feed

    def _run(self, mode, inputs, labels):
        entry, feed = self._prep(mode, inputs, labels)
        return entry, self._executor().run(entry["run_prog"], feed=feed,
                                           fetch_list=entry["fetch"])

    def train_batch_async(self, inputs, labels=None):
        """Submit one train step into the async window; its loss comes
        back as a lazy fetch, so the host keeps dispatching while the
        card computes."""
        entry, feed = self._prep("train", inputs, labels)
        if self._train_runner is None:
            from ..fluid.async_pipeline import AsyncStepRunner
            self._train_runner = AsyncStepRunner(
                self._executor(), entry["run_prog"], entry["fetch"])
        return self._train_runner.submit(feed)

    def drain(self):
        if self._train_runner is not None:
            self._train_runner.drain()

    def abort(self):
        if self._train_runner is not None:
            self._train_runner.abort()

    def _loss_and_metrics(self, mode, inputs, labels):
        _, outs = self._run(mode, inputs, labels)
        loss = float(np.asarray(outs[0]).reshape(-1)[0])
        return [loss] + [_np_metric(outs[1], labels)
                         for _ in self.model._metrics]

    def train_batch(self, inputs, labels=None):
        return self._loss_and_metrics("train", inputs, labels)

    def eval_batch(self, inputs, labels=None):
        return self._loss_and_metrics("eval", inputs, labels)

    def predict_batch(self, inputs):
        _, outs = self._run("predict", inputs, [])
        return [np.asarray(o) for o in outs]

    def _all_params(self):
        """The construction-time parameters and those made at build time
        (a static batch norm's moving statistics)."""
        seen = {}
        for p in self._orig_main.all_parameters():
            seen[p.name] = p
        for e in self._progs.values():
            for p in e["prog"].all_parameters():
                seen.setdefault(p.name, p)
        return list(seen.values())

    def state_dict(self):
        from ..fluid.core import global_scope
        scope = global_scope()
        out = {}
        for p in self._all_params():
            v = scope.find_var(p.name)
            if v is not None:
                out[p.name] = v.detach().cpu().numpy() \
                    if hasattr(v, "detach") else np.asarray(v)
        return out

    def set_state_dict(self, state):
        import torch
        from ..fluid.core import global_scope
        scope = global_scope()
        device = self._executor().device
        for k, v in state.items():
            scope.set_var(k, torch.from_numpy(np.array(v)).to(device))

    def parameters(self):
        return self._all_params()


def _np_metric(logits, labels):
    """The accuracy of the last axis's argmax; 0.0 where the labels do
    not match the predictions one for one (the reference's answer there,
    given here by a test and not by catching every error)."""
    lbl = _as_list(labels)
    if not lbl:
        return 0.0
    lbl = np.asarray(lbl[0]).reshape(-1)
    pred = np.argmax(np.asarray(logits), axis=-1).reshape(-1)
    if lbl.size != pred.size and 1 not in (lbl.size, pred.size):
        return 0.0
    return float((pred == lbl).mean())


def _static_optimizer(opt):
    """A fluid optimizer as it is; a 2.0 eager one mapped onto its fluid
    counterpart."""
    if opt is None:
        raise ValueError("Model.prepare(optimizer=...) required for fit")
    from ..fluid import optimizer as fopt
    if isinstance(opt, fopt.Optimizer):
        return opt
    name = type(opt).__name__
    lr = opt.get_lr() if hasattr(opt, "get_lr") else 0.001
    # Momentum reads the eager optimizer's _mu, which holds its momentum;
    # the reference reads _momentum, which its eager Momentum lacks, and
    # so runs at 0.9 whatever was asked (ROADMAP queue C)
    table = {"SGD": lambda: fopt.SGDOptimizer(lr),
             "Momentum": lambda: fopt.MomentumOptimizer(
                 lr, getattr(opt, "_mu", 0.9)),
             "Adam": lambda: fopt.AdamOptimizer(lr),
             "AdamW": lambda: fopt.AdamWOptimizer(
                 lr, weight_decay=getattr(opt, "_weight_decay", 0.01)
                 or 0.01),
             "Adagrad": lambda: fopt.AdagradOptimizer(lr),
             "RMSProp": lambda: fopt.RMSPropOptimizer(lr)}
    if name not in table:
        raise ValueError(f"no static mapping for optimizer {name}; pass a "
                         f"fluid.optimizer.* instance in static mode")
    return table[name]()


class Model:
    def __init__(self, network: Layer, inputs=None, labels=None):
        self.network = network
        self._inputs = inputs
        self._labels = labels
        self._optimizer = None
        self._loss = None
        self._metrics = []
        self._amp_level = None
        self._amp_dtype = "bfloat16"
        # the adapter is chosen at construction, as in the reference
        self._adapter = None if in_dygraph_mode() else _StaticAdapter(self)

    def prepare(self, optimizer=None, loss=None, metrics=None,
                amp_level=None, amp_dtype="bfloat16"):
        """``amp_level``: None or "O0" is float32; "O1" and "O2" are bf16
        mixed precision, the same here: the static adapter runs the
        train program through the AMP passes, the dygraph one runs each
        batch under ``amp.auto_cast``, and the parameters stay float32
        either way."""
        self._optimizer = optimizer
        self._loss = loss
        self._metrics = (metrics if isinstance(metrics, (list, tuple))
                         else [metrics]) if metrics else []
        lvl = amp_level
        if isinstance(lvl, str):
            lvl = lvl.upper()
            if lvl not in ("O0", "O1", "O2"):
                raise ValueError(
                    f"amp_level must be one of None/'O0'/'O1'/'O2', "
                    f"got {amp_level!r}")
        elif lvl:
            lvl = "O1"
        self._amp_level = lvl or None
        self._amp_dtype = amp_dtype
        return self

    # -- core steps ----------------------------------------------------------
    def _autocast(self):
        if self._amp_level in (None, "O0"):
            return contextlib.nullcontext()
        from ..amp import auto_cast
        return auto_cast(enable=True, dtype=self._amp_dtype)

    def train_batch(self, inputs, labels=None):
        if self._adapter is not None:
            return self._adapter.train_batch(inputs, labels)
        self.network.train()
        ins = [_eager(x) for x in _as_list(inputs)]
        lbs = [_eager(x) for x in _as_list(labels)]
        with self._autocast():
            outs = _as_list(self.network(*ins))
        loss = self._loss(*outs, *lbs) if self._loss else outs[0]
        if loss.shape not in ((), (1,)):
            from ..fluid import layers as L
            loss = L.nn.mean(loss)
        loss.backward()
        self._optimizer.step()
        self._optimizer.clear_grad()
        metrics = [_eval_metric(outs, lbs) for _ in self._metrics]
        return [float(loss)] + metrics

    def eval_batch(self, inputs, labels=None):
        if self._adapter is not None:
            return self._adapter.eval_batch(inputs, labels)
        self.network.eval()
        ins = [_eager(x) for x in _as_list(inputs)]
        lbs = [_eager(x) for x in _as_list(labels)]
        with self._autocast():
            outs = _as_list(self.network(*ins))
        loss = self._loss(*outs, *lbs) if self._loss else outs[0]
        metrics = [_eval_metric(outs, lbs) for _ in self._metrics]
        lv = float(np.asarray(loss.numpy()).reshape(-1)[0]) \
            if hasattr(loss, "numpy") else float(loss)
        return [lv] + metrics

    def predict_batch(self, inputs):
        if self._adapter is not None:
            return self._adapter.predict_batch(inputs)
        self.network.eval()
        ins = [_eager(x) for x in _as_list(inputs)]
        outs = _as_list(self.network(*ins))
        return [o.numpy() for o in outs]

    # -- loops ---------------------------------------------------------------
    def fit(self, train_data=None, eval_data=None, batch_size=1, epochs=1,
            eval_freq=1, log_freq=10, save_dir=None, save_freq=1,
            verbose=2, drop_last=False, shuffle=True, num_workers=0,
            callbacks=None, checkpoint_dir=None, checkpoint_freq=1):
        if checkpoint_dir is not None:
            raise NotImplementedError(
                "fit(checkpoint_dir=...): the elastic checkpoint plane "
                "(fluid/checkpoint.py, distributed/elastic.py) is not "
                "ported yet (ROADMAP queue A item 9)")
        loader = _as_loader(train_data, batch_size, shuffle, drop_last,
                            num_workers)
        if self._adapter is not None:
            # the loader's exact batch sizes; always reassigned, so one
            # fit's edges never reach the next fit's programs
            edges = getattr(loader, "bucket_edges", None)
            self._adapter._bucket_edges = tuple(edges) if edges else None
        cbs = cb_mod.CallbackList(callbacks or [
            cb_mod.ProgBarLogger(log_freq, verbose)])
        cbs.set_model(self)
        cbs.on_train_begin()
        self.stop_training = False
        # the async window only without metrics: metrics are computed on
        # the host from each batch's outputs, which would materialize
        # every step anyway
        use_async = self._adapter is not None and not self._metrics
        try:
            return self._fit_epochs(loader, eval_data, batch_size, epochs,
                                    eval_freq, save_dir, save_freq, cbs,
                                    use_async)
        except BaseException:
            if use_async:
                # a later fit() or evaluate() must not run the aborted
                # epoch's buffered feeds
                self._adapter.abort()
            raise

    def _fit_epochs(self, loader, eval_data, batch_size, epochs, eval_freq,
                    save_dir, save_freq, cbs, use_async):
        history = []
        for epoch in range(epochs):
            cbs.on_epoch_begin(epoch)
            losses = []
            for step, batch in enumerate(loader):
                cbs.on_train_batch_begin(step)
                ins, lbs = _split_batch(batch)
                if use_async:
                    fut = self._adapter.train_batch_async(ins, lbs)
                    vals = [fut.lazy(0)]
                else:
                    vals = self.train_batch(ins, lbs)
                losses.append(vals[0])
                cbs.on_train_batch_end(step, {"loss": vals})
                if use_async:
                    # a step a full window behind is done (or nearly):
                    # fold its loss to a float, so a long epoch pins no
                    # device scalar a step
                    r = self._adapter._train_runner
                    idx = len(losses) - 1 - \
                        (r.max_inflight + 1) * r.steps_per_dispatch
                    if idx >= 0 and not isinstance(losses[idx], float):
                        losses[idx] = float(losses[idx])
            if use_async:
                self._adapter.drain()
            logs = {"loss": float(np.mean([float(v) for v in losses]))
                    if losses else float("nan")}
            if eval_data is not None and (epoch + 1) % eval_freq == 0:
                logs["eval_loss"] = self.evaluate(eval_data,
                                                  batch_size)["loss"]
            history.append(logs)
            cbs.on_epoch_end(epoch, logs)
            if save_dir and (epoch + 1) % save_freq == 0:
                self.save(f"{save_dir}/epoch_{epoch}")
            if self.stop_training:
                break
        cbs.on_train_end()
        return history

    def evaluate(self, eval_data, batch_size=1, log_freq=10, verbose=2,
                 num_workers=0, callbacks=None):
        loader = _as_loader(eval_data, batch_size, False, False,
                            num_workers)
        losses, metrics = [], []
        for batch in loader:
            ins, lbs = _split_batch(batch)
            vals = self.eval_batch(ins, lbs)
            losses.append(vals[0])
            if len(vals) > 1:
                metrics.append(vals[1:])
        out = {"loss": float(np.mean(losses))}
        if metrics:
            out["metrics"] = np.mean(np.asarray(metrics), axis=0).tolist()
        return out

    def predict(self, test_data, batch_size=1, num_workers=0,
                stack_outputs=False, callbacks=None):
        loader = _as_loader(test_data, batch_size, False, False,
                            num_workers)
        outs = []
        for batch in loader:
            ins, _ = _split_batch(batch)
            outs.append(self.predict_batch(ins))
        if stack_outputs:
            return [np.concatenate([o[i] for o in outs])
                    for i in range(len(outs[0]))]
        return outs

    # -- persistence ---------------------------------------------------------
    def save(self, path, training=True):
        """Both adapters write ``save_dygraph``'s ``.pdparams``, so a file
        saved by one loads in the other."""
        from ..dygraph.checkpoint import save_dygraph
        if self._adapter is not None:
            save_dygraph(self._adapter.state_dict(), path)
            return
        save_dygraph(self.network.state_dict(), path)

    def load(self, path, skip_mismatch=False, reset_optimizer=False):
        from ..dygraph.checkpoint import load_dygraph
        params, _ = load_dygraph(path)
        if self._adapter is not None:
            self._adapter.set_state_dict(params)
            return
        self.network.set_dict(params)

    def parameters(self):
        if self._adapter is not None:
            return self._adapter.parameters()
        return self.network.parameters()

    def summary(self, input_size=None, dtype=None):
        lines = [f"Model: {type(self.network).__name__}"]
        total = 0
        for name, p in self.network.named_parameters():
            n = int(np.prod(p.shape))
            total += n
            lines.append(f"  {name:50s} {str(p.shape):20s} {n}")
        lines.append(f"Total params: {total:,}")
        print("\n".join(lines))
        return {"total_params": total}


def _eager(x):
    """A batch as a VarBase: a loader under a tracer already gives
    VarBases, a tensor is wrapped where it lies, and an array goes to
    the tracer's device."""
    if isinstance(x, VarBase):
        return x
    return to_variable(x if isinstance(x, torch.Tensor) else np.asarray(x))


def _eval_metric(outs, labels):
    """The ``accuracy`` op's top-1 accuracy where it applies (outputs of
    rank 2, labels of shape [N, 1]); 0.0 otherwise, as the reference
    answers there.  A fault inside ``accuracy`` raises."""
    from ..fluid.layers.metric_op import accuracy as acc_layer
    if not outs or not labels:
        return 0.0
    out, lbl = outs[0], labels[0]
    if len(out.shape) != 2 or tuple(lbl.shape) != (out.shape[0], 1):
        return 0.0
    return float(np.asarray(acc_layer(out, lbl).numpy()).reshape(-1)[0])


def _as_list(x):
    if x is None:
        return []
    return list(x) if isinstance(x, (list, tuple)) else [x]


def _split_batch(batch):
    items = _as_list(batch)
    if len(items) >= 2:
        return items[:-1], items[-1:]
    return items, []


def _as_loader(data, batch_size, shuffle, drop_last, num_workers=0):
    from ..fluid.reader import DataLoader
    if data is None:
        return []
    if hasattr(data, "__iter__") and not hasattr(data, "__getitem__"):
        return data
    return DataLoader(data, batch_size=batch_size, shuffle=shuffle,
                      drop_last=drop_last, num_workers=num_workers)
