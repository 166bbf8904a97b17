"""Exact integer core of Whack-a-Mole: bit reversal, profiles, spraying,
profile updates and the feedback controller."""

from repro_torch.core.bitrev import bit_reverse32, theta
from repro_torch.core.profile import (
    PathProfile,
    cumulative,
    from_cumulative,
    make_profile,
    quantize_profile,
    uniform_profile,
    validate_profile,
)
from repro_torch.core.spray import (
    SprayMethod,
    SprayState,
    make_spray_state,
    reseed,
    select_path,
    spray_batch,
    spray_key,
    spray_paths,
)
from repro_torch.core.updates import (
    update_embodiment1,
    update_embodiment2,
    update_embodiment3,
    update_embodiment4,
)
from repro_torch.core.feedback import (
    ControllerState,
    PathStats,
    alpha_for_severity,
    controller_step,
    make_controller,
    restore_path,
    severity_weights,
    weighted_badness,
    whack_down,
)
from repro_torch.core.deviation import (
    deviation_from_start,
    interval_deviation,
    max_deviation,
    path_deviations,
)
from repro_torch.core.timevarying import (
    PathSpec,
    Phase,
    completion_time,
    optimal_completion,
    optimal_two_path_schedule,
    static_profile_completion,
)

__all__ = [k for k in dir() if not k.startswith("_")]
