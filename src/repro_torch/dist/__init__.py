"""Real distributed execution harness: master/worker coded rounds with
fault injection, elastic supervision, and measured telemetry.  Port of
``src/repro/dist``.

See ``docs/scheme_kernels.md`` ("Real execution harness") for the
transport contract, timeout/retry semantics, injection knobs, and the
telemetry -> ``TraceModel`` recording schema, and
``docs/fault_tolerance.md`` for the supervision state machine,
checkpoint/resume format, degradation policy, and chaos campaigns.  The
port keeps that contract; its ``HarnessConfig`` adds ``device`` (grad
mode), and its grad-mode values travel as float32 numpy arrays.

The names below load on first use: a spawned linear-mode worker imports
``repro_torch.dist.worker`` through this package and so never pays for
torch.
"""

import importlib

_EXPORTS = {
    "chaos": [
        "CampaignReport", "ChaosCampaign", "delayed_rejoin", "flapping",
        "kill_wave", "lossy_network", "partition_heal", "regional_outage",
        "run_campaign",
    ],
    "injection": ["FaultSpec", "NetFaultSpec", "enact_delay"],
    "master": [
        "HarnessConfig", "HarnessError", "HarnessResult", "degrade_params",
        "run_harness",
    ],
    "net": [
        "FrameDecoder", "FrameError", "MidFilter", "NetConnection", "TcpHost",
        "TcpWorkerLink", "encode_frame", "start_worker_tcp",
    ],
    "supervisor": ["RespawnPolicy", "Supervisor"],
    "telemetry": ["RoundRecord", "RunLedger", "WorkerRoundStat"],
    "transport": [
        "WorkerLink", "start_worker", "start_workers", "stop_workers",
        "wait_any",
    ],
    "worker": ["TaskComputer", "WorkerSetup", "linear_job_data", "worker_main"],
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = [
    "FaultSpec",
    "NetFaultSpec",
    "enact_delay",
    "FrameDecoder",
    "FrameError",
    "MidFilter",
    "NetConnection",
    "TcpHost",
    "TcpWorkerLink",
    "encode_frame",
    "start_worker_tcp",
    "partition_heal",
    "lossy_network",
    "HarnessConfig",
    "HarnessError",
    "HarnessResult",
    "degrade_params",
    "run_harness",
    "RespawnPolicy",
    "Supervisor",
    "ChaosCampaign",
    "CampaignReport",
    "run_campaign",
    "kill_wave",
    "flapping",
    "regional_outage",
    "delayed_rejoin",
    "RoundRecord",
    "RunLedger",
    "WorkerRoundStat",
    "WorkerLink",
    "start_worker",
    "start_workers",
    "stop_workers",
    "wait_any",
    "TaskComputer",
    "WorkerSetup",
    "linear_job_data",
    "worker_main",
]


def __getattr__(name: str):
    mod = _MODULE_OF.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{mod}"), name)


def __dir__():
    return sorted(set(globals()) | set(__all__))
