"""Model zoo of the port (the BERT family, ResNet, ImageClassifier, the
LeNet smoke config, the recommenders and Seq2seq so far)."""

from .bert import BERT, BERTClassifier, BERTNER, BERTSQuAD, squad_span_loss
from .common import ZooModel
from .image import ImageClassifier, ResNet, lenet
from .recommendation import (NCFTail, NeuralCF, SessionRecommender,
                             UserItemFeature, UserItemPrediction,
                             WideAndDeep)
from .seq2seq import RNNDecoder, RNNEncoder, Seq2seq

__all__ = ["ZooModel", "BERT", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "squad_span_loss", "ResNet", "ImageClassifier", "lenet",
           "NeuralCF", "NCFTail", "WideAndDeep", "SessionRecommender",
           "UserItemFeature", "UserItemPrediction", "Seq2seq",
           "RNNEncoder", "RNNDecoder"]
