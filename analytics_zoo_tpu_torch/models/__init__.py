"""Model zoo of the port (the BERT family so far)."""

from .bert import BERT, BERTClassifier, BERTNER, BERTSQuAD, squad_span_loss
from .common import ZooModel

__all__ = ["ZooModel", "BERT", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "squad_span_loss"]
