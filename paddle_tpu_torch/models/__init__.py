"""Models (counterpart of ``paddle_tpu.models``): the static BERT and CTR
demo programs (static_graphs.py), the dygraph BERT family (bert.py), the
Transformer NMT model (transformer.py), the language models
(language.py: SkipGram, PtbLm) and the dygraph CTR models (ctr.py:
WideDeep, DeepFM)."""
from .static_graphs import build_bert_train_program, bert_demo_feed
from .transformer import TransformerModel
from .language import SkipGram, PtbLm
from .ctr import WideDeep, DeepFM
