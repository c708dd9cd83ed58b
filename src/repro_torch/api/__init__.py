"""The port's public API: ``DealConfig`` and ``Session``."""
from repro_torch.api.config import (ClusterSpec, ConfigError, DealConfig,
                                    ExecutorSpec, GraphSpec, ModelSpec,
                                    PartitionSpec, QoSSpec, RefreshSpec,
                                    StoreSpec, TelemetrySpec)
from repro_torch.api.registry import (EXECUTORS, MODELS, register_executor,
                                      register_model)
from repro_torch.api.session import Session

__all__ = ["ClusterSpec", "ConfigError", "DealConfig", "ExecutorSpec",
           "GraphSpec", "ModelSpec", "PartitionSpec", "QoSSpec",
           "RefreshSpec", "StoreSpec", "TelemetrySpec", "EXECUTORS",
           "MODELS", "register_executor", "register_model", "Session"]
