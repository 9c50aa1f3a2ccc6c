"""String-addressable trace sources: ``"msr:web_0?rescale=0.5&limit=2000"``.

The registry lets every run API, benchmark cell, and doc example name a
trace with one string instead of wiring loaders and transform chains by
hand.  Grammar::

    spec        := [scheme ":"] name ["?" params]
    scheme      := "synthetic" | "msr" | "blktrace"
    params      := key "=" value ("&" key "=" value)*

Bare names (no scheme) resolve to synthetic profiles (``"websearch"``)
or to sources registered via :func:`register_source`.  File schemes
(``msr`` / ``blktrace``) resolve ``name`` against the search path
(:func:`add_search_path`; defaults: ``$REPRO_TRACE_DIR``, ``./traces``,
``./tests/data``, and the repo's ``tests/data`` when running from a
checkout), trying the bare name plus ``.csv`` / ``.txt`` / ``.gz``
suffixes.

Recognized params (each maps to one transform, applied in a fixed
canonical order — filter, window, limit, dense, rescale, sample — so a
spec is a *set* of knobs, not an ordered program; build a
:class:`~repro_torch.flashsim.workloads.base.TraceSource` directly for custom
chains):

    ``rw=read|write``     keep one request class (RWFilter)
    ``start=U`` ``end=U`` arrival window in us (Window)
    ``limit=N``           first N requests (Truncate)
    ``dense=0|1``         dense footprint remap (DenseRemap;
                          **default 1 for file schemes**, 0 for synthetic)
    ``rescale=F``         arrival-rate multiplier (TimeRescale)
    ``iops=X``            rescale to an absolute target IOPS (TimeRescale)
    ``sample=F``          seeded Bernoulli subsample (Subsample)
    ``pages=K``           ingestion page size in KiB (file schemes only)
    ``action=A``          blktrace event class to keep (default Q)

Every resolved source flows through the shared content-hash-keyed trace
cache (:meth:`TraceSource.trace`), the file-backed extension of the
synthetic layer's ``cached_trace`` memoization.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Callable, Dict, List, Union

from repro_torch.flashsim.workloads.base import TraceSource, Workload
from repro_torch.flashsim.workloads.ingest import FileSource
from repro_torch.flashsim.workloads.synthetic import SyntheticSource, make_workloads
from repro_torch.flashsim.workloads.transforms import (
    DenseRemap,
    RWFilter,
    Subsample,
    TimeRescale,
    Truncate,
    Window,
)

_FILE_SCHEMES = {"msr": ("csv",), "blktrace": ("txt", "log")}

#: Transform types that sit AFTER ``limit`` in the canonical param order
#: (filter, window, limit, dense, rescale, sample).  The run APIs'
#: ``n_requests`` knob inserts its Truncate before the first of these so
#: it lands exactly where ``?limit=N`` would — keep this tuple in sync
#: with :func:`_build_transforms`, which is the order's definition.
POST_LIMIT_TRANSFORMS = (DenseRemap, TimeRescale, Subsample)

#: Explicitly registered named sources (name -> source or factory).
_NAMED: Dict[str, Union[TraceSource, Callable[[], TraceSource]]] = {}

#: Directories searched (in order) when resolving file-scheme names.
_SEARCH_PATHS: List[Path] = []


def _default_search_paths() -> List[Path]:
    paths = []
    env = os.environ.get("REPRO_TRACE_DIR")
    if env:
        paths.append(Path(env))
    cwd = Path.cwd()
    paths += [cwd / "traces", cwd / "tests" / "data"]
    # Running from a checkout: <repo>/tests/data relative to this file
    # (src/repro/flashsim/workloads/registry.py -> parents[4] == <repo>).
    repo = Path(__file__).resolve().parents[4]
    paths.append(repo / "tests" / "data")
    return paths


def trace_search_paths() -> List[Path]:
    """The active search path (user-added entries first)."""
    return list(_SEARCH_PATHS) + _default_search_paths()


def add_search_path(path) -> None:
    """Prepend a directory to the file-scheme search path."""
    _SEARCH_PATHS.insert(0, Path(path))


def register_source(name: str,
                    source: Union[TraceSource,
                                  Callable[[], TraceSource]]) -> None:
    """Register a source (or zero-arg factory) under a bare name."""
    _NAMED[name] = source


def resolve_trace_file(name: str, scheme: str) -> Path:
    """Find ``name`` on the search path (exact, +ext, +.gz variants)."""
    exts = _FILE_SCHEMES[scheme]
    candidates = [name]
    for ext in exts:
        candidates += [f"{name}.{ext}", f"{name}.{ext}.gz"]
    candidates.append(f"{name}.gz")
    tried = []
    for d in trace_search_paths():
        for c in candidates:
            p = d / c
            tried.append(p)
            if p.is_file():
                return p
    raise FileNotFoundError(
        f"trace {scheme}:{name} not found; searched "
        f"{[str(d) for d in trace_search_paths()]} for {candidates} "
        f"(set REPRO_TRACE_DIR or add_search_path() to extend)"
    )


def _parse_params(query: str, spec: str) -> Dict[str, str]:
    params: Dict[str, str] = {}
    for item in query.split("&"):
        if not item:
            continue
        if "=" not in item:
            raise ValueError(
                f"malformed param {item!r} in trace spec {spec!r} "
                f"(expected key=value)"
            )
        k, v = item.split("=", 1)
        if k in params:
            raise ValueError(f"duplicate param {k!r} in trace spec {spec!r}")
        params[k] = v
    return params


def _build_transforms(params: Dict[str, str], default_dense: bool,
                      spec: str) -> list:
    """Params -> transform chain in canonical order (see module doc)."""
    def pop_num(key, conv):
        v = params.pop(key, None)
        if v is None:
            return None
        try:
            return conv(v)
        except ValueError:
            raise ValueError(
                f"trace spec {spec!r}: {key}= must be a number, got {v!r}"
            ) from None

    def pop_float(key):
        return pop_num(key, float)

    chain = []
    rw = params.pop("rw", None)
    if rw is not None:
        chain.append(RWFilter(keep=rw))
    start, end = pop_float("start"), pop_float("end")
    if start is not None or end is not None:
        chain.append(Window(start_us=start or 0.0,
                            end_us=end if end is not None else float("inf")))
    limit = pop_num("limit", int)
    if limit is not None:
        chain.append(Truncate(limit))
    dense = params.pop("dense", None)
    if dense is None:
        dense_on = default_dense
    elif dense.lower() in ("0", "false", "no", "off"):
        dense_on = False
    elif dense.lower() in ("1", "true", "yes", "on"):
        dense_on = True
    else:
        raise ValueError(
            f"trace spec {spec!r}: dense= must be 0/1 (got {dense!r})"
        )
    if dense_on:
        chain.append(DenseRemap())
    rescale, iops = pop_float("rescale"), pop_float("iops")
    if rescale is not None and iops is not None:
        raise ValueError(
            f"trace spec {spec!r} sets both rescale= and iops= "
            f"(pick one intensity knob)"
        )
    if rescale is not None:
        chain.append(TimeRescale(factor=rescale))
    elif iops is not None:
        chain.append(TimeRescale(target_iops=iops))
    sample = pop_float("sample")
    if sample is not None:
        chain.append(Subsample(sample))
    return chain


def get_source(spec: Union[str, TraceSource, Workload]) -> TraceSource:
    """Resolve a spec string (or pass through a source / wrap a profile)."""
    if isinstance(spec, TraceSource):
        return spec
    if isinstance(spec, Workload):
        return SyntheticSource(spec)
    if not isinstance(spec, str):
        raise TypeError(
            f"trace spec must be a str, TraceSource or Workload, "
            f"got {type(spec).__name__}"
        )

    body, _, query = spec.partition("?")
    scheme, sep, name = body.partition(":")
    if not sep:
        scheme, name = "", body
    params = _parse_params(query, spec)

    if scheme in _FILE_SCHEMES:
        pages = params.pop("pages", None)
        try:
            page_kib = 16 if pages is None else int(pages)
        except ValueError:
            raise ValueError(
                f"trace spec {spec!r}: pages= must be an integer (KiB), "
                f"got {pages!r}"
            ) from None
        # action= is a blktrace knob; on msr specs it must fail like any
        # other unknown param rather than being silently swallowed.
        action = params.pop("action", "Q") if scheme == "blktrace" else "Q"
        chain = _build_transforms(params, default_dense=True, spec=spec)
        if params:
            raise ValueError(
                f"unknown param(s) {sorted(params)} in trace spec {spec!r}"
            )
        path = resolve_trace_file(name, scheme)
        return FileSource(
            path=str(path), fmt=scheme, page_kib=page_kib,
            blktrace_action=action, transforms=tuple(chain), label=body,
        )

    if scheme in ("", "synthetic"):
        chain = _build_transforms(params, default_dense=False, spec=spec)
        if params:
            raise ValueError(
                f"unknown param(s) {sorted(params)} in trace spec {spec!r}"
            )
        profiles = make_workloads()
        if name in profiles:
            return SyntheticSource(profiles[name], transforms=tuple(chain))
        reg = _NAMED.get(name)
        if reg is not None:
            src = reg() if callable(reg) and not isinstance(
                reg, TraceSource) else reg
            return src.with_transforms(*chain) if chain else src
        raise KeyError(
            f"unknown trace source {name!r}: not a synthetic profile "
            f"({sorted(profiles)}) or a registered source "
            f"({sorted(_NAMED)})"
        )

    raise ValueError(
        f"unknown trace scheme {scheme!r} in {spec!r} "
        f"(choose from: synthetic, {', '.join(_FILE_SCHEMES)})"
    )
