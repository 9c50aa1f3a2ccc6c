"""Workload subsystem: pluggable trace sources for the SSD simulator.

Layered package (formerly the single-module synthetic generator; every
pre-refactor ``repro_torch.flashsim.workloads`` import keeps working):

  * :mod:`~repro_torch.flashsim.workloads.base`       — trace schema
    (:class:`Workload`, :class:`RequestTrace` + validation) and the
    :class:`TraceSource` abstraction with process-wide trace caching;
  * :mod:`~repro_torch.flashsim.workloads.synthetic`  — the MMPP generator and
    the ``PROFILES`` / ``GC_PROFILES`` presets (moved verbatim;
    bit-identical per seed, pinned by tests);
  * :mod:`~repro_torch.flashsim.workloads.ingest`     — MSR-Cambridge CSV and
    blktrace text-dump loaders (:class:`FileSource`);
  * :mod:`~repro_torch.flashsim.workloads.transforms` — composable trace
    transforms (dense footprint remap, time rescale, filters, windows,
    seeded subsampling);
  * :mod:`~repro_torch.flashsim.workloads.stats`      — measured trace
    statistics (:func:`trace_stats`), validating the synthetic
    generator's shapes and summarizing ingested traces;
  * :mod:`~repro_torch.flashsim.workloads.registry`   — string-addressable
    sources (``"msr:web_0?rescale=0.5"``) with search-path file
    resolution.

See ``docs/workloads.md`` for the trace schema, the registry grammar,
and ingestion quick-starts.
"""

from repro_torch.flashsim.workloads.base import (
    RequestTrace,
    TraceSource,
    Workload,
    clear_trace_cache,
    freeze_trace,
    touched_pages,
)
from repro_torch.flashsim.workloads.ingest import (
    FileSource,
    file_content_hash,
    load_blktrace_txt,
    load_msr_csv,
    open_trace_file,
)
from repro_torch.flashsim.workloads.registry import (
    add_search_path,
    get_source,
    register_source,
    resolve_trace_file,
    trace_search_paths,
)
from repro_torch.flashsim.workloads.stats import (
    TraceStats,
    burstiness_from_scv,
    trace_stats,
)
from repro_torch.flashsim.workloads.synthetic import (
    GC_PROFILES,
    PROFILES,
    SyntheticSource,
    cached_trace,
    generate_trace,
    make_workloads,
)
from repro_torch.flashsim.workloads.transforms import (
    DenseRemap,
    RWFilter,
    Subsample,
    TimeRescale,
    Truncate,
    Window,
)

__all__ = [
    # schema + sources
    "RequestTrace",
    "TraceSource",
    "Workload",
    "SyntheticSource",
    "FileSource",
    "clear_trace_cache",
    "freeze_trace",
    "touched_pages",
    # synthetic profiles (pre-refactor surface)
    "GC_PROFILES",
    "PROFILES",
    "cached_trace",
    "generate_trace",
    "make_workloads",
    # ingestion
    "file_content_hash",
    "load_blktrace_txt",
    "load_msr_csv",
    "open_trace_file",
    # registry
    "add_search_path",
    "get_source",
    "register_source",
    "resolve_trace_file",
    "trace_search_paths",
    # stats
    "TraceStats",
    "burstiness_from_scv",
    "trace_stats",
    # transforms
    "DenseRemap",
    "RWFilter",
    "Subsample",
    "TimeRescale",
    "Truncate",
    "Window",
]
