"""Source-to-source control-flow rewriting (ProgramTranslator core;
counterpart of ``paddle_tpu/dygraph/dygraph_to_static/ast_transformer.py``,
plain Python kept as its own copy).

Reference: dygraph_to_static/program_translator.py:729 + the transformer
stack under dygraph_to_static/*.py.  ``ast_to_static(fn)`` parses the
function's source and rewrites

* ``if`` statements            -> convert_ifelse(pred, true_fn, false_fn, ..)
* ``while`` statements         -> convert_while_loop(cond_fn, body_fn, ..)
* ``for t in range(...)``      -> desugared to a while, then converted

so a tensor predicate is read on the host and the branch or the trip it
names runs eagerly (convert_operators.py), while plain-Python predicates
keep exact Python semantics (the convert_* helpers dispatch at runtime).
Regions carrying ``return``/``break``/``continue`` are left untouched
(they are correct for Python predicates; a tensor predicate there is
read by ``VarBase.__bool__``, where the reference's trace raises jax's
concretization error).  Functions whose source is unavailable or that
close over free variables fall back to running as written.
"""
from __future__ import annotations

import ast
import inspect
import textwrap


def _store_names(stmts):
    """Names bound by a statement list, ignoring nested function/class
    scopes (their assignments are invisible to this frame)."""
    names = []

    class V(ast.NodeVisitor):
        def visit_FunctionDef(self, node):
            names.append(node.name)

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_ClassDef(self, node):
            names.append(node.name)

        def visit_Lambda(self, node):
            pass

        def _target(self, t):
            if isinstance(t, ast.Name):
                names.append(t.id)
            elif isinstance(t, (ast.Tuple, ast.List)):
                for e in t.elts:
                    self._target(e)
            elif isinstance(t, ast.Starred):
                self._target(t.value)

        def visit_Assign(self, node):
            for t in node.targets:
                self._target(t)
            self.generic_visit(node)

        def visit_AugAssign(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_AnnAssign(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_NamedExpr(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_For(self, node):
            self._target(node.target)
            self.generic_visit(node)

        def visit_With(self, node):
            for item in node.items:
                if item.optional_vars is not None:
                    self._target(item.optional_vars)
            self.generic_visit(node)

    v = V()
    for s in stmts:
        v.visit(s)
    return names


def _load_names(node):
    out = []
    for n in ast.walk(node):
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load):
            out.append(n.id)
    return out


def _has_flow_escape(stmts):
    """return/break/continue at THIS nesting level (not inside nested
    loops or functions, whose escapes stay local)."""
    class V(ast.NodeVisitor):
        found = False

        def visit_Return(self, node):
            self.found = True

        def visit_Break(self, node):
            self.found = True

        def visit_Continue(self, node):
            self.found = True

        def visit_For(self, node):
            # break/continue inside a nested loop are fine; a return is not
            for s in node.body + node.orelse:
                if any(isinstance(n, ast.Return) for n in ast.walk(s)):
                    self.found = True

        visit_While = visit_For

        def visit_FunctionDef(self, node):
            pass

        visit_AsyncFunctionDef = visit_FunctionDef

        def visit_Lambda(self, node):
            pass

    v = V()
    for s in stmts:
        v.visit(s)
    return v.found


def _name(id_, ctx=None):
    return ast.Name(id=id_, ctx=ctx or ast.Load())


def _tuple(names, ctx=None):
    return ast.Tuple(elts=[_name(n, ctx or ast.Load()) for n in names],
                     ctx=ctx or ast.Load())


def _jst_attr(fn_name):
    return ast.Attribute(value=_name("_jst"), attr=fn_name, ctx=ast.Load())


def _const(v):
    return ast.Constant(value=v)


class _ControlFlowTransformer(ast.NodeTransformer):
    def __init__(self):
        self._n = 0

    def _uid(self):
        self._n += 1
        return self._n

    # -- shared pieces ------------------------------------------------------
    def _unbind_undefined(self, names):
        """`if x is _jst.UNDEFINED: del x` — a name untouched by the taken
        Python branch must stay UNBOUND after the region (NameError on
        later reads, exactly as in the original source)."""
        out = []
        for n in names:
            test = ast.Compare(left=_name(n), ops=[ast.Is()],
                               comparators=[_jst_attr("UNDEFINED")])
            out.append(ast.If(test=test,
                              body=[ast.Delete(
                                  targets=[ast.Name(id=n,
                                                    ctx=ast.Del())])],
                              orelse=[]))
        return out

    def _ensure_bound(self, names):
        """x = x if _jst.defined(lambda: x) else _jst.undefined()"""
        out = []
        for n in names:
            thunk = ast.Lambda(
                args=ast.arguments(posonlyargs=[], args=[], kwonlyargs=[],
                                   kw_defaults=[], defaults=[]),
                body=_name(n))
            test = ast.Call(func=_jst_attr("defined"), args=[thunk],
                            keywords=[])
            out.append(ast.Assign(
                targets=[_name(n, ast.Store())],
                value=ast.IfExp(
                    test=test, body=_name(n),
                    orelse=ast.Call(func=_jst_attr("undefined"), args=[],
                                    keywords=[]))))
        return out

    def _fn_def(self, fname, argnames, body, ret_names):
        args = ast.arguments(
            posonlyargs=[],
            args=[ast.arg(arg=a) for a in argnames],
            kwonlyargs=[], kw_defaults=[], defaults=[])
        ret = ast.Return(value=_tuple(ret_names))
        return ast.FunctionDef(name=fname, args=args,
                               body=(body or [ast.Pass()]) + [ret],
                               decorator_list=[])

    # -- if -----------------------------------------------------------------
    def visit_If(self, node):
        self.generic_visit(node)
        if _has_flow_escape(node.body) or _has_flow_escape(node.orelse):
            return node
        names = sorted(set(_store_names(node.body))
                       | set(_store_names(node.orelse)))
        names = [n for n in names if not n.startswith("_jst")]
        u = self._uid()
        tname, fname = f"_jst_true_{u}", f"_jst_false_{u}"
        stmts = self._ensure_bound(names)
        stmts.append(self._fn_def(tname, names, node.body, names))
        stmts.append(self._fn_def(fname, names, node.orelse, names))
        call = ast.Call(
            func=_jst_attr("convert_ifelse"),
            args=[node.test, _name(tname), _name(fname),
                  ast.Tuple(elts=[_const(n) for n in names],
                            ctx=ast.Load()),
                  _tuple(names)],
            keywords=[])
        if names:
            stmts.append(ast.Assign(targets=[_tuple(names, ast.Store())],
                                    value=call))
            stmts.extend(self._unbind_undefined(names))
        else:
            stmts.append(ast.Expr(value=call))
        return stmts

    # -- while --------------------------------------------------------------
    def visit_While(self, node):
        self.generic_visit(node)
        if node.orelse or _has_flow_escape(node.body):
            return node
        # carry = vars assigned in the body (loop-INVARIANT reads in the
        # test — modules, layers, bounds — ride the generated functions'
        # closure instead; putting them in the carry would shadow globals
        # with UNDEFINED and reject non-tensor values)
        names = sorted(set(_store_names(node.body)))
        names = [n for n in names if not n.startswith("_jst")]
        u = self._uid()
        cname, bname = f"_jst_cond_{u}", f"_jst_body_{u}"
        stmts = self._ensure_bound(names)
        cond_fn = ast.FunctionDef(
            name=cname,
            args=ast.arguments(posonlyargs=[],
                               args=[ast.arg(arg=a) for a in names],
                               kwonlyargs=[], kw_defaults=[], defaults=[]),
            body=[ast.Return(value=node.test)], decorator_list=[])
        stmts.append(cond_fn)
        stmts.append(self._fn_def(bname, names, node.body, names))
        call = ast.Call(
            func=_jst_attr("convert_while_loop"),
            args=[_name(cname), _name(bname),
                  ast.Tuple(elts=[_const(n) for n in names],
                            ctx=ast.Load()),
                  _tuple(names)],
            keywords=[])
        if names:
            stmts.append(ast.Assign(targets=[_tuple(names, ast.Store())],
                                    value=call))
            stmts.extend(self._unbind_undefined(names))
        else:
            stmts.append(ast.Expr(value=call))
        return stmts

    # -- for over range -> while desugar ------------------------------------
    def visit_For(self, node):
        if not (isinstance(node.iter, ast.Call)
                and isinstance(node.iter.func, ast.Name)
                and node.iter.func.id == "range"
                and isinstance(node.target, ast.Name)
                and not node.orelse
                and not _has_flow_escape(node.body)):
            self.generic_visit(node)
            return node
        u = self._uid()
        a = node.iter.args
        start = a[0] if len(a) >= 2 else _const(0)
        stop = a[1] if len(a) >= 2 else (a[0] if a else _const(0))
        step = a[2] if len(a) >= 3 else _const(1)
        i = node.target.id
        # internal counter (prefix "_d2s": carried, unlike "_jst_" helper
        # names) so `i` keeps Python semantics: it holds the LAST USED
        # value after the loop and stays unbound on empty ranges
        it = f"_d2s_it_{u}"
        stop_v, step_v = f"_jst_stop_{u}", f"_jst_step_{u}"
        pre = [ast.Assign(targets=[_name(it, ast.Store())], value=start),
               ast.Assign(targets=[_name(stop_v, ast.Store())],
                          value=stop),
               ast.Assign(targets=[_name(step_v, ast.Store())],
                          value=step)]
        # step-sign-aware bound check (negative ranges must iterate)
        test = ast.Call(func=_jst_attr("range_cond"),
                        args=[_name(it), _name(stop_v), _name(step_v)],
                        keywords=[])
        bind = ast.Assign(targets=[_name(i, ast.Store())], value=_name(it))
        incr = ast.AugAssign(target=_name(it, ast.Store()), op=ast.Add(),
                             value=_name(step_v))
        w = ast.While(test=test, body=[bind] + list(node.body) + [incr],
                      orelse=[])
        out = self.visit_While(w)
        return pre + (out if isinstance(out, list) else [out])


def ast_to_static(fn):
    """Return a control-flow-converted version of `fn`, or None when the
    transform cannot apply (no source, closures, transform error) — the
    caller falls back to plain tracing, like ProgramTranslator's
    error path."""
    try:
        closure_ns = {}
        if fn.__code__.co_freevars:
            if "__class__" in fn.__code__.co_freevars:
                return None     # zero-arg super() needs a real cell; a
                # snapshotted global raises at CALL time, past the
                # fallback — so fall back to tracing here
            # recompiling drops the closure; snapshot the cell values into
            # the namespace (bound-at-transform-time semantics — fine for
            # the usual captured modules/layers, the reference's converted
            # functions have the same property)
            for name, cell in zip(fn.__code__.co_freevars,
                                  fn.__closure__ or ()):
                closure_ns[name] = cell.cell_contents   # may raise -> None
        src = textwrap.dedent(inspect.getsource(fn))
        tree = ast.parse(src)
        fdef = tree.body[0]
        if not isinstance(fdef, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        fdef.decorator_list = []              # drop @declarative itself
        new_body = []
        tr = _ControlFlowTransformer()
        for stmt in fdef.body:
            r = tr.visit(stmt)
            new_body.extend(r if isinstance(r, list) else [r])
        if tr._n == 0:
            return fn                         # nothing to convert
        fdef.body = new_body
        ast.fix_missing_locations(tree)
        from . import convert_operators
        ns = dict(fn.__globals__)
        ns.update(closure_ns)
        ns["_jst"] = convert_operators
        code = compile(tree, filename=f"<dygraph_to_static "
                       f"{fn.__qualname__}>", mode="exec")
        exec(code, ns)                        # noqa: S102 — controlled src
        new_fn = ns[fdef.name]
        new_fn.__defaults__ = fn.__defaults__
        new_fn.__kwdefaults__ = fn.__kwdefaults__
        return new_fn
    except (OSError, TypeError, SyntaxError, ValueError):
        return None
