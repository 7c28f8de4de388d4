"""Elastic runtime: churn-tolerant membership, straggler detection, live
re-scheduling, and closed-loop cost calibration over the FusionLLM stack
(beyond-paper; see README §Elastic).

Composition: scripted :class:`ChurnTrace` -> lease-based
:class:`MembershipView` + executor :class:`StepTiming` / ``LinkTiming``
telemetry aggregated by :class:`TelemetryLog` into the EWMA
:class:`StragglerDetector`'s observations and the per-link calibration
windows -> :func:`replan` (keep / anchored / full candidates — OP-Fence or
the joint co-planner — minimal migration plan; :func:`interim_schedule` for
the overlapped mode's immediate restart) -> :mod:`migrate` (bit-exact state
movement over the checkpoint wire format) -> :class:`ElasticController`
(drives the runtime across epochs, auto-fits link corrections from the
telemetry with hysteresis, re-plans when the calibrated pace diverges, and
charges the discrete-event clock for detection, blocking migration, and
pipeline refill — background migration streams while training continues on
bandwidth-shared links).
"""
from .membership import (ChurnEvent, ChurnTrace, MembershipDelta,
                         MembershipView, single_failure_trace)
from .detector import StragglerDetector
from .telemetry import TelemetryLog
from .replan import (MigrationPlan, OpMove, ReplanResult, cross_cluster_bytes,
                     diff_schedules, interim_schedule, replan, state_bytes)
from .migrate import (apply_moves, assert_bitexact, extract_op_state,
                      pack_op_state, trees_bitexact, unpack_op_state)
from .controller import (ElasticController, ElasticRunResult, EpochRecord,
                         StepRecord)
