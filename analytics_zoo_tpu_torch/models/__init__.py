"""Model zoo of the port (the BERT family, ResNet, ImageClassifier and the
LeNet smoke config so far)."""

from .bert import BERT, BERTClassifier, BERTNER, BERTSQuAD, squad_span_loss
from .common import ZooModel
from .image import ImageClassifier, ResNet, lenet

__all__ = ["ZooModel", "BERT", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "squad_span_loss", "ResNet", "ImageClassifier", "lenet"]
