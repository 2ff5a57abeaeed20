from ...dygraph.dygraph_to_static.convert_operators import (
    convert_ifelse, convert_while_loop, convert_logical_and,
    convert_logical_or, convert_logical_not, convert_len, convert_assert,
    convert_print, convert_pop, convert_var_dtype, convert_var_shape,
    convert_shape_compare, cast_bool_if_necessary)

__all__ = ["cast_bool_if_necessary", "convert_assert", "convert_ifelse",
           "convert_len", "convert_logical_and", "convert_logical_not",
           "convert_logical_or", "convert_pop", "convert_print",
           "convert_shape_compare", "convert_var_dtype",
           "convert_var_shape", "convert_while_loop"]
