"""The port's public API: ``DealConfig``, ``Session`` and the four plugin
registries (executors, models, store eviction and admission)."""
from repro_torch.api.config import (ClusterSpec, ConfigError, DealConfig,
                                    ExecutorSpec, GraphSpec, ModelSpec,
                                    PartitionSpec, QoSSpec, RefreshSpec,
                                    StoreSpec, TelemetrySpec,
                                    tenants_from_string)
from repro_torch.api.registry import (ADMISSIONS, EVICT_POLICIES, EXECUTORS,
                                      MODELS, register_admission,
                                      register_evict_policy,
                                      register_executor, register_model)
from repro_torch.api.session import Session

__all__ = ["ClusterSpec", "ConfigError", "DealConfig", "ExecutorSpec",
           "GraphSpec", "ModelSpec", "PartitionSpec", "QoSSpec",
           "RefreshSpec", "StoreSpec", "TelemetrySpec",
           "tenants_from_string", "ADMISSIONS", "EVICT_POLICIES",
           "EXECUTORS", "MODELS", "register_admission",
           "register_evict_policy", "register_executor", "register_model",
           "Session"]
