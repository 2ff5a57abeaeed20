"""The RNN cells: paddle_tpu_torch against paddle_tpu.

The three cells of ``nn/layer.py`` (one step, given states or the zero
default), ``RNN`` and ``BiRNN`` over a cell, and the 1.x ``dygraph.rnn``
cells with their ``(hidden_size, input_size)`` order, each built in both
packages from the reference's ``state_dict`` and checked as
``test_torch_rnn.py`` checks the fused layers: outputs and states to
rtol 1e-5, the tape's first-step gradients of ``sum(out · c)`` to rtol
1e-5 of each tensor's largest value.  (The reference runs a cell op by
op, and its tape traces a vjp for each, so these are kept apart from
the fused layers to hold each file's time.)
"""
import pytest

from tests.test_torch_rnn import B, D, H, T, _x, check_against_reference

CELL_CASES = {
    "simple_rnn_cell_relu": (
        lambda nn, r, L: nn.SimpleRNNCell(D, H, activation="relu"),
        lambda m, mods, v: m(v[0], v[1]), [_x(B, D), _x(B, H, seed=1)]),
    "lstm_cell_zero_state": (
        lambda nn, r, L: nn.LSTMCell(D, H),
        lambda m, mods, v: m(v[0]), [_x(B, D)]),
    "lstm_cell": (
        lambda nn, r, L: nn.LSTMCell(D, H),
        lambda m, mods, v: m(v[0], (v[1], v[2])),
        [_x(B, D), _x(B, H, seed=1), _x(B, H, seed=2)]),
    "gru_cell": (
        lambda nn, r, L: nn.GRUCell(D, H),
        lambda m, mods, v: m(v[0], v[1]), [_x(B, D), _x(B, H, seed=1)]),
    "rnn_over_lstm_cell": (
        lambda nn, r, L: nn.RNN(nn.LSTMCell(D, H)),
        lambda m, mods, v: m(v[0]), [_x(B, T, D)]),
    "rnn_reverse_time_major_gru_cell": (
        lambda nn, r, L: nn.RNN(nn.GRUCell(D, H), is_reverse=True,
                                time_major=True),
        lambda m, mods, v: m(v[0], v[1]), [_x(T, B, D), _x(B, H, seed=3)]),
    "birnn": (
        lambda nn, r, L: nn.BiRNN(nn.SimpleRNNCell(D, H),
                                  nn.LSTMCell(D, H)),
        lambda m, mods, v: m(v[0]), [_x(B, T, D)]),
    "fluid_lstm_cell": (
        lambda nn, r, L: r.LSTMCell(H, D),
        lambda m, mods, v: m(v[0], v[1], v[2]),
        [_x(B, D), _x(B, H, seed=1), _x(B, H, seed=2)]),
    "fluid_gru_cell": (
        lambda nn, r, L: r.GRUCell(H, D),
        lambda m, mods, v: m(v[0], v[1]), [_x(B, D), _x(B, H, seed=1)]),
}


@pytest.mark.parametrize("case", sorted(CELL_CASES))
def test_cell_matches_reference(case):
    check_against_reference(case, *CELL_CASES[case])
