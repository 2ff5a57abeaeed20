"""dy2static logging (reference dygraph_to_static/logging_utils.py;
counterpart of ``paddle_tpu/dygraph/dygraph_to_static/logging_utils.py``)."""
from __future__ import annotations

import logging
import os

__all__ = ["TranslatorLogger", "set_verbosity", "set_code_level"]


class TranslatorLogger:
    def __init__(self):
        self.logger = logging.getLogger("paddle_tpu_torch.dy2static")
        self.verbosity_level = int(
            os.environ.get("TRANSLATOR_VERBOSITY", "0"))
        self.transformed_code_level = int(
            os.environ.get("TRANSLATOR_CODE_LEVEL", "-1"))

    def log(self, level, msg, *args):
        if level <= self.verbosity_level:
            self.logger.warning(msg, *args)

    def log_transformed_code(self, level, ast_node_or_code, func_name=""):
        if self.transformed_code_level >= 0 and \
                level >= self.transformed_code_level:
            code = ast_node_or_code if isinstance(ast_node_or_code, str) \
                else "<ast>"
            print(f"--- transformed code of {func_name} ---\n{code}")


_logger = TranslatorLogger()


def set_verbosity(level=0, also_to_stdout=False):
    _logger.verbosity_level = int(level)


def set_code_level(level=100, also_to_stdout=False):
    _logger.transformed_code_level = int(level)
