"""The paper's contribution as a composable runtime, on the card: the port
of ``repro.core`` (DESIGN.md §2).

Public surface:
    Workload, WorkloadKind, WorkloadClass, classify      — P2
    ResourceMonitor, NodeCapacity                        — P3
    ContainerExecutor, UnikernelExecutor, ExecutableImage — P1
    Orchestrator, placement policies                     — P4
    ServiceSpec, ConfigurationManager, EdgeSystem        — fig 2
    DispatchStats, DispatchSample                        — telemetry
"""
from repro_torch.core.admission import (AdmissionController,
                                        AdmissionDecision, AdmissionError,
                                        TenantQuota, can_preempt)
from repro_torch.core.executor import (BaseExecutor, ContainerExecutor,
                                       ExecutableImage, ExecutorClass,
                                       IncompatibleWorkload,
                                       UnikernelExecutor)
from repro_torch.core.manager import ConfigurationManager, DispatchResult
from repro_torch.core.orchestrator import (BinPackPolicy, Deployment,
                                           LeastLoadedPolicy, Orchestrator,
                                           PlacementError, RoundRobinPolicy,
                                           POLICIES)
from repro_torch.core.registry import ImageRegistry
from repro_torch.core.resources import NodeCapacity, ResourceMonitor
from repro_torch.core.scheduler import (SpeculativeRunner, WorkQueue,
                                        clone_args)
from repro_torch.core.spec import QOS_RANK, QoSClass, ServiceSpec, auto_spec
from repro_torch.core.system import EdgeSystem
from repro_torch.core.telemetry import (DispatchSample, DispatchStats,
                                        percentile)
from repro_torch.core.workload import (ClassifierConfig, Workload,
                                       WorkloadClass, WorkloadKind, classify)

__all__ = [
    "AdmissionController", "AdmissionDecision", "AdmissionError",
    "TenantQuota", "can_preempt", "BaseExecutor", "ContainerExecutor",
    "ExecutableImage", "ExecutorClass", "IncompatibleWorkload",
    "UnikernelExecutor", "ConfigurationManager", "DispatchResult",
    "Deployment", "Orchestrator", "PlacementError", "RoundRobinPolicy",
    "LeastLoadedPolicy", "BinPackPolicy", "POLICIES", "ImageRegistry",
    "NodeCapacity", "ResourceMonitor", "SpeculativeRunner", "WorkQueue",
    "clone_args", "QOS_RANK", "QoSClass", "ServiceSpec", "auto_spec",
    "EdgeSystem", "DispatchSample", "DispatchStats", "percentile",
    "ClassifierConfig", "Workload", "WorkloadClass", "WorkloadKind",
    "classify",
]
