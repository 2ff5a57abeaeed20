"""ProgramTranslator (reference dygraph_to_static/program_translator.py
:729; counterpart of
``paddle_tpu/dygraph/dygraph_to_static/program_translator.py``): the
dygraph->static conversion facade — enable/disable switch +
function/program/code extraction over the AST converter tier."""
from __future__ import annotations

import inspect

__all__ = ["ProgramTranslator", "convert_to_static"]


def convert_to_static(function):
    from .ast_transformer import ast_to_static
    out = ast_to_static(function)
    return function if out is None else out


class ProgramTranslator:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._initialized = False
        return cls._instance

    def __init__(self):
        if self._initialized:
            return
        self._initialized = True
        self.enable_to_static = True

    @classmethod
    def get_instance(cls):
        return cls()

    def enable(self, enable_to_static):
        self.enable_to_static = bool(enable_to_static)

    def get_func(self, dygraph_func):
        if not self.enable_to_static:
            return dygraph_func
        return convert_to_static(dygraph_func)

    def get_output(self, dygraph_func, *args, **kwargs):
        return self.get_func(dygraph_func)(*args, **kwargs)

    def get_program(self, dygraph_func, *args, **kwargs):
        """Trace the converted function into a static Program (inputs must
        be static-mode Variables or data layers created by the caller)."""
        from ...fluid import Program, program_guard
        main, startup = Program(), Program()
        with program_guard(main, startup):
            outs = self.get_func(dygraph_func)(*args, **kwargs)
        return main, startup, [], outs

    def get_code(self, dygraph_func):
        import ast
        import textwrap
        try:
            src = textwrap.dedent(inspect.getsource(dygraph_func))
            return ast.unparse(ast.parse(src))
        except (OSError, TypeError, SyntaxError):
            return "<source unavailable>"
