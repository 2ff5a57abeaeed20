"""Models (counterpart of ``paddle_tpu.models``): the static BERT and CTR
demo programs (static_graphs.py), the dygraph BERT family (bert.py) and
the Transformer NMT model (transformer.py)."""
from .static_graphs import build_bert_train_program, bert_demo_feed
from .transformer import TransformerModel
