"""The fabrics and the sender engine of the port."""

from repro_torch.net.fabric import FabricParams, FabricState, fabric_tick, init_fabric
from repro_torch.net.sender import (
    SenderParams,
    SenderSpec,
    completion_need,
    policy_sweep_params,
    run_flows,
    run_flows_sized,
    run_message,
    run_message_on,
    sender_params,
    stack_params,
    sweep_flows,
    sweep_message,
)
from repro_torch.net.telemetry import (
    TelemetryFrame,
    TelemetrySpec,
    chrome_trace,
    event_onsets,
    frame_select,
    queue_percentiles,
    read_series_jsonl,
    recovery_ticks,
    series,
    summarize_recovery,
    write_series_jsonl,
)
from repro_torch.net.topology import (
    EventSchedule,
    SharedFabricState,
    TopologyParams,
    init_shared_fabric,
    leaf_spine,
    null_schedule,
    shared_fabric_tick,
    single_flow_stepper,
)
from repro_torch.net.transport import (
    Policy,
    SimResult,
    TransportConfig,
    simulate_flows,
    simulate_message,
    simulate_message_on,
)
from repro_torch.net.collectives import (
    CollectiveConfig,
    allgather_cct,
    allgather_cct_shared,
    allreduce_cct,
    allreduce_cct_shared,
    ettr,
    ideal_step_ticks,
    ring_steps_cct_shared,
    ring_topology,
    step_cct,
    step_cct_shared,
    sweep_ring_cct_shared,
)
from repro_torch.net.scenarios import SCENARIOS, cluster_scenarios, job_scenarios
from repro_torch.net.cluster import (
    Cluster,
    ClusterJob,
    ClusterResult,
    cluster_topology,
    jain_index,
    link_utilization,
    place_jobs,
    run_cluster,
    sweep_cluster,
)
from repro_torch.net.jobs import (
    JobPhase,
    JobResult,
    JobSchedule,
    compile_job,
    job_ettr,
    run_job,
    run_job_steps,
    sweep_job,
    sweep_job_steps,
    total_packets,
)
from repro_torch.net.fountain import (
    decode_overhead_curve,
    encode,
    peel_decode,
    robust_soliton,
    sample_encoding,
)

__all__ = [k for k in dir() if not k.startswith("_")]
