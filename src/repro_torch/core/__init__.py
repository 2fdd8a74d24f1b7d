"""FairKV core: the paper's contribution as a composable library (host-side
numpy, the port's own copy of ``repro.core``).

Workflow (paper §4.1):  compression policy → per-head length statistics
(`profiles`) → best-effort assignment + fair-copying (`planner`) →
`HeadPlacement` plan → consumed by the serving runtime (weight permutation +
slot-layout KV cache) and by the efficiency/throughput simulators.
"""
from repro_torch.core.assignment import assign_items, backtracking, greedy_lpt, local_search  # noqa: F401
from repro_torch.core.efficiency import SimResult, simulate, utilization_from_loads  # noqa: F401
from repro_torch.core.latency import LinearLatencyModel, RooflineLatencyModel  # noqa: F401
from repro_torch.core.placement import HeadPlacement, LayerPlacement, layer_from_assignment  # noqa: F401
from repro_torch.core.planner import (  # noqa: F401
    PLANNER_MODES,
    PlannerConfig,
    build_plan,
    plan_kv_dtypes,
    plan_layer,
    replan_for_stragglers,
)
from repro_torch.core.profiles import (  # noqa: F401
    cosine_similarity,
    profile_from_lengths,
    profile_from_samples,
    synthetic_profile,
)
