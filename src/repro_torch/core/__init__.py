"""ThinkAir core on PyTorch: profile-driven computation offloading (the
controller, ``@remote``, the parallelizer, the profilers and energy
models) and the host side of the serving fleet (clock, clones, dispatch,
scheduling, faults, the gateway, venues)."""
from repro_torch.core.clock import (BaseClock, Event, FunctionClock,
                                    SystemClock, VirtualClock, ensure_clock)
from repro_torch.core.clones import (CLONE_TYPES, GPU_BY_CLONE_TYPE,
                                     GPU_CLONE_TYPES, KV_SCALE_BY_CLONE_TYPE,
                                     CircuitBreaker, Clone, CloneHealth,
                                     ClonePool, CloneState, chips_for,
                                     resume_time, usd_per_second)
from repro_torch.core.controller import ExecutionController, ExecutionResult
from repro_torch.core.dispatch import CloneTask, Dispatcher
from repro_torch.core.energy import (GpuCoeffs, GpuEnergyModel, PhoneState,
                                     PowerTutorModel)
from repro_torch.core.faults import (CloneFault, FaultInjector, FaultPlan,
                                     ReconnectManager, VenueFailure)
from repro_torch.core.gateway import (AdmissionEstimator, ResponseCache,
                                      StreamingGateway, TenantPolicy,
                                      TokenBucket)
from repro_torch.core.parallel import (ParallelResult, Parallelizer,
                                       split_batch, split_range)
from repro_torch.core.policy import (Policy, Prediction, placement_key,
                                     should_offload)
from repro_torch.core.profilers import (DeviceProfiler, NetworkProfiler,
                                        ProgramProfiler, size_bucket)
from repro_torch.core.remoteable import (REGISTRY, RemoteableMethod, remote,
                                         set_default_controller)
from repro_torch.core.scheduler import (AdmissionQueue, FleetAutoscaler,
                                        PlacementEngine, ServeCompletion,
                                        ServeRequest, poisson_arrivals)
from repro_torch.core.venues import (LINKS, Venue, VenueSpec, pytree_bytes,
                                     transfer_time)

__all__ = [
    "BaseClock", "Event", "FunctionClock", "SystemClock", "VirtualClock",
    "ensure_clock",
    "CLONE_TYPES", "KV_SCALE_BY_CLONE_TYPE", "GPU_BY_CLONE_TYPE",
    "GPU_CLONE_TYPES", "CircuitBreaker", "Clone", "CloneHealth",
    "ClonePool", "CloneState", "chips_for",
    "resume_time", "usd_per_second",
    "ExecutionController", "ExecutionResult", "CloneTask", "Dispatcher",
    "PhoneState", "PowerTutorModel", "GpuCoeffs", "GpuEnergyModel",
    "CloneFault", "FaultInjector",
    "FaultPlan", "ReconnectManager", "VenueFailure",
    "AdmissionEstimator", "ResponseCache", "StreamingGateway",
    "TenantPolicy", "TokenBucket", "ParallelResult",
    "Parallelizer", "split_batch", "split_range", "Policy", "Prediction",
    "placement_key", "should_offload",
    "DeviceProfiler", "NetworkProfiler", "ProgramProfiler",
    "size_bucket", "REGISTRY", "RemoteableMethod", "remote",
    "set_default_controller", "AdmissionQueue", "FleetAutoscaler",
    "PlacementEngine", "ServeCompletion", "ServeRequest", "poisson_arrivals",
    "LINKS", "Venue", "VenueSpec", "pytree_bytes", "transfer_time",
]
