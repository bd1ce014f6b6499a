"""NNFrames: DataFrame-native train/transform, the Spark ML Pipeline
analog (port of ``analytics_zoo_tpu/nnframes``).

Reference (SURVEY.md §2.3 "NNFrames"): ``NNEstimator.fit(df)`` trained a
BigDL model straight from DataFrame columns via ``Preprocessing``
converters and returned an ``NNModel`` Spark-ML transformer;
``NNClassifier``/``NNClassifierModel`` specialized to class labels;
``NNImageReader`` loaded images into a DataFrame.

The "DataFrame" is pandas: one frame or an ``XShards`` of frames.  The
estimator/transformer contract is kept: ``fit`` returns an ``NNModel``
whose ``transform(df)`` appends a prediction column.  The train path is
the port's ``Estimator`` underneath (on the card, one CUDA graph a batch
key).
"""

from .nn_classifier import (NNEstimator, NNModel, NNClassifier,
                            NNClassifierModel)
from .nn_image_reader import NNImageReader

__all__ = ["NNEstimator", "NNModel", "NNClassifier", "NNClassifierModel",
           "NNImageReader"]
