"""The Estimator API (counterpart of
``mxnet_tpu/gluon/contrib/estimator/``)."""
from .estimator import Estimator  # noqa: F401
from .event_handler import (BatchBegin, BatchEnd, CheckpointHandler,  # noqa: F401
                            EarlyStoppingHandler, EpochBegin, EpochEnd,
                            EventHandler, HealthHandler, LoggingHandler,
                            MetricHandler, StoppingHandler, TrainBegin,
                            TrainEnd, ValidationHandler)
