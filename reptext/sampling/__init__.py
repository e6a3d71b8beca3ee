"""Flow-matching schedule + fused denoising loop."""

from reptext.sampling.flow_match import (  # noqa: F401
    FlowMatchSchedule,
    calculate_shift,
    build_schedule,
)
