"""Configuration of the PyTorch port: the fields its serving and training
slices and its pipeline services read.

Environment variables keep the JAX package's names and defaults
(``LO_HOME``, ``LO_SERVE_MAX_BATCH``, ``LO_SERVE_QUEUE``,
``LO_REQUEST_TIMEOUT``, ``LO_COMPUTE_DTYPE``, ``LO_MAX_WORKERS``,
``LO_CKPT_QUARANTINE_KEEP``, ``LO_CKPT_ASYNC``, ``LO_CKPT_INFLIGHT``,
``LO_FAULT_INJECT``, the sweeps' ``LO_SWEEP_FUSION``,
``LO_SWEEP_EARLYSTOP_MARGIN``, ``LO_SWEEP_EARLYSTOP_MIN_EPOCHS``,
``LO_SWEEP_EARLYSTOP_ALPHA``, the feature plane's
``LO_SCAN_FIT_MAX_BYTES`` (the staged fit's budget),
``LO_PREFETCH_BUFFER``, ``LO_PARAM_CACHE`` and ``LO_ARENA_BYTES``, and
the paged and
quantized serving knobs ``LO_SERVE_KV``, ``LO_SERVE_PAGE_LEN``,
``LO_SERVE_PAGES``, ``LO_SERVE_TENANT_WEIGHTS``, ``LO_SERVE_KV_DTYPE``,
``LO_SERVE_WEIGHTS``, ``LO_SERVE_DRIFT_MAX``, ``LO_SERVE_DRIFT_EVERY``,
the bucketed ``LO_SERVE_BUCKETS`` and ``LO_SERVE_MAX_WAIT_MS``, and the
disaggregated and speculative ``LO_SERVE_DISAGG``, ``LO_SERVE_DRAFT`` and
``LO_SERVE_SPEC_K``, and the sandbox's ``LO_SANDBOX``, ``LO_SANDBOX_MAX``,
``LO_PREFLIGHT``, ``LO_SANDBOX_CPU_SECONDS``, ``LO_SANDBOX_MEMORY_BYTES``
and ``LO_SANDBOX_FILE_BYTES``, the job lifecycle's ``LO_JOB_RETRIES``,
``LO_JOB_TIMEOUT``, ``LO_STALL_SECONDS``, ``LO_STALL_ESCALATE``,
``LO_RETRY_BACKOFF`` and ``LO_RETRY_BACKOFF_MAX``, the card lease's
``LO_POOL_WEIGHTS``, ``LO_FAIR_SERVED_HALF_LIFE``, ``LO_MESH_YIELD`` and
``LO_SERVE_LEASE_POLICY``, the process group's ``LO_MESH_SHAPE``, the
health sentinel's
``LO_HEALTH_ACTION``, ``LO_HEALTH_SPIKE_FACTOR``, ``LO_HEALTH_EMA_ALPHA``,
``LO_HEALTH_MAX_ROLLBACKS``, ``LO_HEALTH_COOLDOWN`` and
``LO_HEALTH_RETRIES``, and the gateway's ``LO_GET_CACHE_TTL`` and
``LO_GATEWAY_MAX_INFLIGHT``, and the observability plane's knobs of
``docs/OBSERVABILITY.md``: ``LO_TRACE``, ``LO_TRACE_RING``,
``LO_TIMELINE_RING``, ``LO_EVENT_LOG``, ``LO_EVENT_LOG_MAX_BYTES``,
``LO_TRANSFER_GUARD``, ``LO_MONITOR``, ``LO_MONITOR_INTERVAL_MS``,
``LO_MONITOR_RING``, the ``LO_SLO_*`` objectives and windows,
``LO_FOOTPRINT_CALIBRATE``, ``LO_FOOTPRINT_MARGIN``, ``LO_INCIDENTS``,
``LO_INCIDENT_KEEP``, ``LO_INCIDENT_COOLDOWN_S``,
``LO_INCIDENT_PROFILE_S``, ``LO_PROFILE_MAX_SECONDS`` and
``LO_PROFILE_KEEP``; ``LO_PERF``, ``LO_XRAY`` and ``LO_PEAK_*`` are read
at each call, as in the JAX package). The device is chosen in code only
(``device=`` or ``--device``). A :class:`Config` is an object the caller
creates and passes down. The one process-wide reader is the
observability plane, whose registries are process-wide as the JAX
package's are: it reads the config the newest
:class:`~learningorchestra_tpu_torch.services.context.ServiceContext`
installed (:func:`learningorchestra_tpu_torch.observability.get_config`),
else one read from the environment.
"""

from __future__ import annotations

import dataclasses
import os

API_PREFIX = "/api/learningOrchestra/v1"


@dataclasses.dataclass
class Config:
    # storage root (artifacts live under <home>/artifacts)
    home: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_HOME", os.path.join(os.getcwd(), ".lo_store")))
    # worker threads of the job manager
    max_workers: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_MAX_WORKERS", "8")))
    # default slot count of an LM serving session (maxSlots)
    serve_max_batch: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SERVE_MAX_BATCH", "8")))
    # batch-size buckets of a predict session ("1,2,4,..."): a burst of
    # n rows pads to the smallest bucket >= n
    serve_buckets: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_SERVE_BUCKETS", "1,2,4,8,16,32,64"))
    # bounded request queue per serving session; full -> 429
    serve_queue_depth: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_SERVE_QUEUE", "64")))
    # the gateway's deadline on a request (0 = none): past it the client
    # gets 504 while the dispatch goes on; a predict also stops waiting
    # for its tokens then (503)
    request_timeout_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_REQUEST_TIMEOUT", "0")))
    # the most timed dispatches in flight (abandoned ones included)
    # before a timed request gets an instant 503; 0 = no cap
    gateway_max_inflight: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_GATEWAY_MAX_INFLIGHT", "64")))
    # lifetime of a cached GET answer (entries are keyed on the
    # collection's change seq, so this never makes one stale); 0 = off
    get_cache_ttl_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_GET_CACHE_TTL", "300")))
    # how long a predict session waits for more rows before it serves
    # a partial bucket (milliseconds)
    serve_max_wait_ms: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SERVE_MAX_WAIT_MS", "2")))
    # torch device the models run on; "cpu" only when asked for
    device: str = "cuda"
    # training: the batch size when fit() is given none, and the dtype
    # the forward and backward compute in over float32 master params
    default_batch_size: int = 128
    compute_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_COMPUTE_DTYPE",
                                               "bfloat16"))
    # a fit (and a fused sweep cohort) whose training arrays take at
    # most this many bytes, over more than one step an epoch, stages its
    # padded epoch on the card once and gathers each step's rows there;
    # a larger one is fed through the prefetch thread (a fused cohort
    # runs as independent trials); 0 = never stage
    scan_fit_max_bytes: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SCAN_FIT_MAX_BYTES", str(1 << 30))))
    # host batches the prefetch feed (runtime/data.py
    # prefetch_to_device) copies to the card ahead of the step, for a
    # fit that is not staged and takes more than one step an epoch;
    # 0 = no prefetch thread: each step copies its own batch
    prefetch_buffer: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_PREFETCH_BUFFER", "2")))
    # the feature cache's host tier: bytes of materialized dataset reads
    # kept between jobs (0 disables)
    param_cache_bytes: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_PARAM_CACHE", str(256 << 20))))
    # the device arena (runtime/arena.py): bytes of staged tensors kept
    # on the card between jobs; -1 = auto (a quarter of the card's
    # memory), 0 disables
    arena_bytes: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_ARENA_BYTES", "-1")))
    # newest quarantined (corrupt) checkpoint step dirs kept as
    # evidence; older ones are deleted
    ckpt_quarantine_keep: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_CKPT_QUARANTINE_KEEP", "4")))
    # checkpoint commits on a background worker (runtime/async_ckpt.py):
    # the train thread pays a host snapshot per save; off by default
    ckpt_async: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_CKPT_ASYNC", "0") not in ("0", "false", "no", ""))
    # host snapshots queued for commit before save() blocks
    ckpt_inflight: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_CKPT_INFLIGHT", "2")))
    # sweep fusion: GridSearch/RandomSearch train same-architecture
    # points that differ only in optimizer scalars as one stacked
    # program (models/sweep.py); off = every point its own trial
    sweep_fusion: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_SWEEP_FUSION", "1") not in ("0", "false", "no"))
    # a fused config whose EMA validation score trails the cohort's
    # best by more than this stops updating (0 disables), once every
    # config trained min_epochs; alpha smooths the score
    sweep_earlystop_margin: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SWEEP_EARLYSTOP_MARGIN", "0")))
    sweep_earlystop_min_epochs: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SWEEP_EARLYSTOP_MIN_EPOCHS", "2")))
    sweep_earlystop_alpha: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SWEEP_EARLYSTOP_ALPHA", "0.5")))
    # fault injection, site[:count[:mode[:arg]]] (services/faults.py)
    fault_inject: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_FAULT_INJECT", ""))
    # LM session KV layout: "slot" (slots x cacheLen per session) or
    # "paged" (one shared pool of page_len-token pages, handed out per
    # stream on demand, with prefix reuse and tenant quotas)
    serve_kv: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SERVE_KV", "slot"))
    # tokens per KV page
    serve_page_len: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SERVE_PAGE_LEN", "16")))
    # pages per paged session; 0 = the slot cache's bytes (slots x
    # cacheLen / pageLen, plus the trash page)
    serve_pages: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_SERVE_PAGES", "0")))
    # weighted-fair tenant shares of the page budget ("a:3,b:1";
    # unlisted tenants weigh 1)
    serve_tenant_weights: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_SERVE_TENANT_WEIGHTS", ""))
    # paged KV dtype: "bf16" (the model's exact dtype) or "int8"; and the
    # serving-weight dtype: "bf16" (exact), "int8" or "fp8"
    serve_kv_dtype: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SERVE_KV_DTYPE", "bf16"))
    serve_weights: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SERVE_WEIGHTS", "bf16"))
    # quality gate of quantized sessions: the largest quantized-vs-exact
    # drift before the session degrades to exact, probed at create and
    # every serve_drift_every decode steps
    serve_drift_max: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SERVE_DRIFT_MAX", "0.05")))
    serve_drift_every: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SERVE_DRIFT_EVERY", "256")))
    # paged LM sessions as a prefill worker and a decode worker that
    # hand KV pages over by reference ("1" = the default; per-session
    # field "disagg")
    serve_disagg: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SERVE_DISAGG", "0"))
    # the draft model of speculative decoding ("" = none) and the greedy
    # tokens it proposes a round (per-session "draft", "specK")
    serve_draft: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SERVE_DRAFT", ""))
    serve_spec_k: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SERVE_SPEC_K", "4")))
    # the jail of Function code and '#' expressions: "subprocess" (a
    # child interpreter under rlimits and an audit hook that denies
    # reads and writes outside its scratch dir, processes and sockets),
    # "restricted" (in-process, safe builtins and an import whitelist)
    # or "trusted" (plain exec)
    sandbox_mode: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SANDBOX", "subprocess"))
    # the most trust a Function request's "sandboxMode" may ask for
    # (subprocess < restricted < trusted); empty = sandbox_mode, so
    # escalation is the operator's opt-in
    sandbox_max_mode: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_SANDBOX_MAX", ""))
    # the submit-time AST lint of user code (406 with its findings);
    # LO_PREFLIGHT=0 turns it and the sandbox's own lint off
    preflight: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_PREFLIGHT", "1") not in ("0", "false", "no"))
    # the subprocess jail's rlimits: CPU seconds, address space, file size
    sandbox_cpu_seconds: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SANDBOX_CPU_SECONDS", "600")))
    sandbox_memory_bytes: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SANDBOX_MEMORY_BYTES", str(8 << 30))))
    sandbox_file_bytes: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_SANDBOX_FILE_BYTES", str(1 << 30))))

    # job lifecycle: re-runs of a job after a transient error, the
    # default deadline of a job (0 = none; a request's "timeout"
    # overrides), the stall watchdog (a job whose heartbeat went quiet
    # this long is marked stalled, and cancelled when stall_escalate;
    # 0 = no watchdog) and the backoff between retries (base * 2^attempt
    # seconds, capped, times a jitter in [0.5, 1.5))
    job_max_retries: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_JOB_RETRIES", "0")))
    job_timeout_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get("LO_JOB_TIMEOUT", "0")))
    stall_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_STALL_SECONDS", "300")))
    stall_escalate: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_STALL_ESCALATE", "1") not in ("0", "false", "no"))
    retry_backoff_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_RETRY_BACKOFF", "0.5")))
    retry_backoff_max_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_RETRY_BACKOFF_MAX", "30")))
    # the card lease (services/scheduler.py): fair-share weights of the
    # job pools ("train=2,tune=1"; unlisted pools weigh 1), the half-life
    # of each pool's served seconds (0 = all-time totals), yielding to
    # another pool's waiter at an epoch boundary, and whether a serving
    # session yields to any waiter ("preempt") or keeps the card until
    # it is deleted ("hold")
    pool_weights: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_POOL_WEIGHTS", ""))
    fair_served_half_life_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_FAIR_SERVED_HALF_LIFE", "600")))
    # the process group's mesh: "auto" = data parallel over every rank
    # (runtime/mesh.py)
    mesh_shape: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_MESH_SHAPE", "auto"))
    mesh_yield: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_MESH_YIELD", "1") not in ("0", "false", "no"))
    serve_lease_policy: str = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_SERVE_LEASE_POLICY", "preempt"))
    # the training health sentinel's defaults (a request's healthPolicy
    # overrides): action ""/"off" (no sentinel), "skip", "rollback" or
    # "fail"; a spike is an epoch loss above spike_factor x the loss's
    # EMA; rollbacks a fit may take, epochs without the spike check
    # after one; and the job-level re-runs of the "numerical" error class
    health_action: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_HEALTH_ACTION", ""))
    health_spike_factor: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_HEALTH_SPIKE_FACTOR", "4.0")))
    health_ema_alpha: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_HEALTH_EMA_ALPHA", "0.3")))
    health_max_rollbacks: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_HEALTH_MAX_ROLLBACKS", "2")))
    health_cooldown_epochs: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_HEALTH_COOLDOWN", "1")))
    health_retries: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_HEALTH_RETRIES", "1")))

    # the observability plane (observability/): spans and the step
    # timeline (LO_TRACE=0 degrades every tracer call to a shared no-op),
    # spans kept per trace, step windows kept per job
    trace: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_TRACE", "1") not in ("0", "false", "no"))
    trace_ring: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_TRACE_RING", "512")))
    timeline_ring: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_TIMELINE_RING", "4096")))
    # the JSONL lifecycle event log ("" = off) and its size bound: at the
    # bound it rolls to <path>.1 (keep-1); 0 = no rotation
    event_log: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_EVENT_LOG", ""))
    event_log_max_bytes: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_EVENT_LOG_MAX_BYTES", str(64 << 20))))
    # implicit-synchronization sentinel on the train step: "" (off) or
    # "log" (torch.cuda.set_sync_debug_mode("warn"), each warning counted
    # and logged); "fail" is refused at context creation (not ported)
    transfer_guard: str = dataclasses.field(
        default_factory=lambda: os.environ.get("LO_TRANSFER_GUARD", ""))
    # the cluster sampler and the SLO watchdog (LO_MONITOR=0: neither)
    monitor: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_MONITOR", "1") not in ("0", "false", "no"))
    monitor_interval_ms: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_MONITOR_INTERVAL_MS", "1000")))
    monitor_ring: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get(
            "LO_MONITOR_RING", "600")))
    # SLO objectives (0 = off) and their fast and slow burn-rate windows
    slo_serving_p99_ms: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_SERVING_P99_MS", "0")))
    slo_queue_wait_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_QUEUE_WAIT_S", "0")))
    slo_hbm_headroom_frac: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_HBM_HEADROOM_FRAC", "0")))
    slo_deadletter_rate: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_DEADLETTER_RATE", "0")))
    slo_unattributed_growth_bytes: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_UNATTRIBUTED_GROWTH_BYTES", "0")))
    slo_fast_window_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_FAST_WINDOW_S", "10")))
    slo_slow_window_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_SLO_SLOW_WINDOW_S", "60")))
    # footprint calibration: the preflight prefers a job's measured peak
    # device bytes (times the margin) over its static estimate
    footprint_calibrate: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_FOOTPRINT_CALIBRATE", "0") not in ("0", "false", "no"))
    footprint_margin: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_FOOTPRINT_MARGIN", "1.25")))
    # the incident flight recorder: bundles kept, the per-trigger mute
    # window, and the seconds of profiler window a serving-latency page
    # records into its bundle (0 = none)
    incidents: bool = dataclasses.field(
        default_factory=lambda: os.environ.get(
            "LO_INCIDENTS", "1") not in ("0", "false", "no"))
    incident_keep: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_INCIDENT_KEEP", "8")))
    incident_cooldown_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_INCIDENT_COOLDOWN_S", "300")))
    incident_profile_s: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_INCIDENT_PROFILE_S", "0")))
    # POST /profile: the auto-stop of a forgotten session (0 = never) and
    # the trace dirs kept under <home>/profiles
    profile_max_seconds: float = dataclasses.field(
        default_factory=lambda: float(os.environ.get(
            "LO_PROFILE_MAX_SECONDS", "600")))
    profile_keep: int = dataclasses.field(
        default_factory=lambda: int(os.environ.get("LO_PROFILE_KEEP", "8")))

    @property
    def artifacts_dir(self) -> str:
        return os.path.join(self.home, "artifacts")

    @property
    def datasets_dir(self) -> str:
        return os.path.join(self.home, "datasets")

    @property
    def checkpoints_dir(self) -> str:
        return os.path.join(self.home, "checkpoints")

    @property
    def catalog_path(self) -> str:
        return os.path.join(self.home, "catalog.sqlite")


def resolve_device(device):
    """The torch device for ``device``. A CUDA device with no card
    raises: entry points never carry on on the CPU unless asked to."""
    import torch  # here, so that the client and the sandbox's child,
    # which read this module, need no torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but no CUDA device is "
                f"available (pass device='cpu' to run on the CPU)")
        # the JAX serving path computes at the params' float32: keep
        # float32 matmuls and convolutions out of TF32 on the card
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
