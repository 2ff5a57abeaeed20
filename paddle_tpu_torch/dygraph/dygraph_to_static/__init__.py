"""AST-based dygraph-to-static (ProgramTranslator analog; counterpart of
``paddle_tpu/dygraph/dygraph_to_static``).

Reference: python/paddle/fluid/dygraph/dygraph_to_static/
program_translator.py:729 + convert_operators.py — Python source is
rewritten so data-dependent ``if``/``while``/``for range`` become
convert_* calls that dispatch at RUNTIME: plain Python predicates keep
Python control flow; a tensor predicate is read on the host and the
branch or trip it names runs eagerly on the card (the reference lowers
it to ``lax.cond``/``lax.while_loop`` inside its jit trace).
"""
from .ast_transformer import ast_to_static          # noqa: F401
from . import convert_operators                      # noqa: F401

from . import logging_utils  # noqa: E402,F401
from .logging_utils import (TranslatorLogger, set_verbosity,  # noqa: E402,F401
                            set_code_level)
from . import program_translator  # noqa: E402,F401
from .program_translator import (ProgramTranslator,  # noqa: E402,F401
                                 convert_to_static)
from .internal_transformers import (  # noqa: E402,F401
    DygraphToStaticAst, BreakContinueTransformer, LoopTransformer,
    NameVisitor, ReturnTransformer, RETURN_NO_VALUE_MAGIC_NUM,
    RETURN_NO_VALUE_VAR_NAME, AstNodeWrapper, NodeVarType,
    StaticAnalysisVisitor)
from ...jit.dy2static.convert_call_func import convert_call  # noqa: E402,F401
from ...jit.dy2static import variable_trans_func  # noqa: E402,F401
from ...jit.dy2static.variable_trans_func import (  # noqa: E402,F401
    create_bool_as_type, create_fill_constant_node,
    create_static_variable_gast_node, data_layer_not_check,
    to_static_variable, to_static_variable_gast_node)
