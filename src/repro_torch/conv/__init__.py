"""repro_torch.conv — plan/execute convolution engine.

    from repro_torch.conv import plan_conv
    plan = plan_conv(x.shape, k.shape, padding=1)    # cached
    y = plan(x, k)
"""
from repro_torch.conv.registry import (
    BackendInfo, ScheduleInfo, register_backend, register_schedule,
    get_backend, get_schedule, available_backends, available_schedules,
    backend_schedule_pairs,
)
from repro_torch.conv.epilogue import Epilogue
from repro_torch.conv.plan import (
    ConvPlan, PreparedConv, plan_conv, conv2d,
    plan_cache_info, clear_plan_cache, plan_cache_capacity,
    prepared_cache_info, clear_prepared_cache,
)
from repro_torch.conv.stages import stage_trace
from repro_torch.conv.netplan import (
    NetworkConv, NetworkPlan, NetworkProfile, PreparedNetwork,
    BucketedNetworkPlan, plan_network,
    plan_network_buckets, prepare_network_buckets, bucket_report,
)
from repro_torch.conv import autotune
from repro_torch.conv.autotune import TunedConfig, autotune_info
from repro_torch.conv.analyze import (
    PlanProfile, CheckReport, Violation, analyze, register_invariant,
    invariants_for,
)
from repro_torch.conv import backends as _backends

_backends.register_builtin()

__all__ = [
    "ConvPlan", "PreparedConv", "plan_conv", "conv2d", "Epilogue",
    "NetworkConv", "NetworkPlan", "NetworkProfile", "PreparedNetwork",
    "BucketedNetworkPlan", "plan_network",
    "plan_network_buckets", "prepare_network_buckets", "bucket_report",
    "plan_cache_info", "clear_plan_cache", "plan_cache_capacity",
    "prepared_cache_info", "clear_prepared_cache",
    "stage_trace",
    "PlanProfile", "CheckReport", "Violation", "analyze",
    "register_invariant", "invariants_for",
    "autotune", "TunedConfig", "autotune_info",
    "BackendInfo", "ScheduleInfo",
    "register_backend", "register_schedule",
    "get_backend", "get_schedule",
    "available_backends", "available_schedules", "backend_schedule_pairs",
]
