"""Model zoo of the port (the BERT family, ResNet, ImageClassifier, the
LeNet smoke config, the recommenders, Seq2seq, the text models, the
anomaly detector, the SSD object detector), foreign-model import
(``Net``) and ``GraphNet``."""

from .anomalydetection import AnomalyDetector, unroll
from .bert import BERT, BERTClassifier, BERTNER, BERTSQuAD, squad_span_loss
from .common import ZooModel
from .graphnet import GraphNet
from .image import ImageClassifier, ResNet, lenet
from .net import ForeignGraphNet, ForeignNet, Net
from .objectdetection import ObjectDetector, SSDLite, Visualizer
from .recommendation import (NCFTail, NeuralCF, SessionRecommender,
                             UserItemFeature, UserItemPrediction,
                             WideAndDeep)
from .seq2seq import RNNDecoder, RNNEncoder, Seq2seq
from .textclassification import TextClassifier
from .textmatching import KNRM

__all__ = ["ZooModel", "BERT", "BERTClassifier", "BERTNER", "BERTSQuAD",
           "squad_span_loss", "ResNet", "ImageClassifier", "lenet",
           "NeuralCF", "NCFTail", "WideAndDeep", "SessionRecommender",
           "UserItemFeature", "UserItemPrediction", "Seq2seq",
           "RNNEncoder", "RNNDecoder", "TextClassifier", "KNRM",
           "AnomalyDetector", "unroll", "SSDLite", "ObjectDetector",
           "Visualizer", "Net", "ForeignNet", "ForeignGraphNet",
           "GraphNet"]
