"""Serving of the port: ``InferenceModel`` (float, bf16 and int8 serving,
one CUDA graph per batch key on the card) and ``ClusterServing``, the
always-on service around it, with its scheduler, model registry, TCP
client, replica router, HTTP frontend, controller and batch scorer, and
the recsys path's host hot-row ``EmbedCache`` with ``CachedEmbeddingModel``
(the JAX package's names)."""

from .inference_model import InferenceModel, enable_aot_cache
from .model_registry import ModelRegistry
from .scheduler import ContinuousScheduler, Scheduler, WindowScheduler
from .server import ClusterServing
from .client import InputQueue, OutputQueue, RetryPolicy
from .router import CircuitBreaker, ReplicaSet
from .http_frontend import HTTPFrontend
from .controller import (HysteresisPolicy, InProcessReplicaFactory,
                         ReplicaFactory, ReplicaHandle, ScalingPolicy,
                         ServingController, SubprocessReplicaFactory)
from .batch import (BatchJobError, BatchJobReport, BatchScorer,
                    ShadowDeltas, read_output)
from .embed_cache import CachedEmbeddingModel, EmbedCache

__all__ = ["InferenceModel", "enable_aot_cache", "ClusterServing",
           "InputQueue", "OutputQueue", "RetryPolicy",
           "CircuitBreaker", "ReplicaSet",
           "HTTPFrontend", "ModelRegistry",
           "Scheduler", "WindowScheduler", "ContinuousScheduler",
           "ServingController", "ScalingPolicy", "HysteresisPolicy",
           "ReplicaFactory", "ReplicaHandle", "InProcessReplicaFactory",
           "SubprocessReplicaFactory",
           "BatchScorer", "BatchJobReport", "BatchJobError",
           "ShadowDeltas", "read_output", "EmbedCache",
           "CachedEmbeddingModel"]
