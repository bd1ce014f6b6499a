"""Chronos of the port (``analytics_zoo_tpu/chronos``): the time-series
toolkit.

TSDataset (the pandas feature pipeline), the forecasters (LSTM, Seq2Seq,
TCN and MTNet through the Estimator's CUDA graphs; TCMF's factorization
and rollout as loops on the card; ARIMA and Prophet behind their optional
CPU packages), the anomaly detectors (Threshold, AE, DBScan) and AutoTS
over the port's automl package.
"""

from .data import TSDataset
from .forecaster import (LSTMForecaster, Seq2SeqForecaster, TCNForecaster,
                         ARIMAForecaster, ProphetForecaster)
from .mtnet import MTNetForecaster
from .tcmf import TCMFForecaster
from .detector import AEDetector, DBScanDetector, ThresholdDetector
from .autots import (AutoLSTM, AutoSeq2Seq, AutoTCN,
                     AutoTSEstimator, TSPipeline)
from .experimental import XShardsTSDataset

__all__ = ["TSDataset", "XShardsTSDataset", "LSTMForecaster", "Seq2SeqForecaster",
           "TCNForecaster", "MTNetForecaster", "TCMFForecaster",
           "ARIMAForecaster", "ProphetForecaster",
           "AEDetector", "DBScanDetector", "ThresholdDetector",
           "AutoTSEstimator", "TSPipeline",
           "AutoLSTM", "AutoTCN", "AutoSeq2Seq"]
