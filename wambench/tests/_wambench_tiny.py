"""Cells small enough for the CPU: the benchmark's fabrics, patterns and
policies at a few flows and paths."""
from wambench import run

SENDER = dict(coded=True, ell=10, method="SHUFFLE_1", code_overhead=0.05, ctrl_interval=4,
              cwnd=256.0, early_exit=True, exit_chunk=16)
FAT_TREE = dict(fabric="fat_tree", hosts_per_leaf=2, sender=SENDER,
                sizes=dict(n_pods=4, leaves_per_pod=2, spines_per_pod=2, cores_per_spine=2),
                links=dict(uplink_capacity=8.0, queue_limit=12.0, ecn_threshold=4.0,
                           latency_ticks=6, intra_latency_ticks=4, degrade_p=0.02,
                           recover_p=0.1, degrade_factor=0.05, fb_delay=8, ring_len=128))
LEAF_SPINE = dict(fabric="leaf_spine", hosts_per_leaf=4, sender=SENDER,
                  sizes=dict(n_leaves=4, n_spines=4),
                  links=dict(uplink_capacity=8.0, queue_limit=12.0, ecn_threshold=4.0,
                             latency_ticks=4, degrade_p=0.05, recover_p=0.1,
                             degrade_factor=0.05, fb_delay=8, ring_len=128))
PERM = dict(pattern="permutation", packets=48, rate=8, horizon=64, checked_runs=1)
FANOUT = dict(pattern="permutation", fanout=2, packets=24, rate=4, horizon=56, checked_runs=1)
CELLS = {
    "fat_tree.perm_wam": (FAT_TREE, dict(PERM, policy="WAM")),
    "fat_tree.perm_ecmp": (FAT_TREE, dict(PERM, policy="ECMP")),
    "leaf_spine.fanout_wam": (LEAF_SPINE, dict(FANOUT, policy="WAM")),
}
E2E = [{"name": "flow_ticks_per_s", "unit": "flow-ticks/s"}, {"name": "setup_s", "unit": "s"}]


def tiny_cell(name: str) -> run.Cell:
    config, mix = CELLS[name]
    return run.Cell(name, config, mix, 1, E2E, [])
