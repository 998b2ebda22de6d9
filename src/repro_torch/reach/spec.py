"""IndexSpec — the single frozen description of a FERRARI deployment.

The paper's contribution is a *tunable* index: one budget knob ``k`` trades
index size against query latency (§4). IndexSpec captures every build-time
AND serve-time knob in one validated value that round-trips through dicts
(persistence manifests) and argparse (CLIs). Its fields and validation
are those of the reference package's ``IndexSpec``, so a manifest's
``spec`` dict written there loads here through ``from_dict``.

``build`` runs the host builder or the staged device builder
(``builder="wavefront"``, on ``device``). ``make_engine`` builds the
one-device engine for ``placement="single"`` and, for ``"replicated"`` and
``"sharded"``, the multi-device engine over the initialised
torch.distributed process group (``core.distributed``; one process a
device, ``mesh`` "DATAxMODEL" must match its world). ``kernel_impl`` and
``use_pallas`` keep their
names so manifests round-trip, but choose nothing beyond the device: on a
CUDA device the hand-written kernels run, and a spec that asks for the
XLA path (``kernel_impl="xla"``) or the no-kernel path
(``use_pallas=False``) is refused there, by the device build as by the
engine.
"""
from __future__ import annotations

import argparse
from dataclasses import asdict, dataclass, fields
from typing import Optional, Tuple

VARIANTS = ("L", "G", "full")
COVER_METHODS = ("greedy", "dp", "topgap")
BUILDERS = ("host", "wavefront")
PHASE2_MODES = ("auto", "dense", "sparse", "host")
PLACEMENTS = ("single", "replicated", "sharded")
COMPACT_MODES = ("auto", "incremental", "full")
KERNEL_IMPLS = ("xla", "pallas", "auto")
# the knobs baked into a built index — immutable once an artifact exists;
# everything else is a serve-time knob a loader may freely override
BUILD_FIELDS = ("k", "variant", "c", "cover_method", "n_seeds",
                "use_seeds", "precondensed", "builder", "merge_chunk",
                "m_cap")


def parse_mesh(s: str) -> Tuple[int, int]:
    """Parse a ``'DATAxMODEL'`` mesh string, e.g. ``'4x2'`` → (4, 2)."""
    parts = str(s).lower().split("x")
    try:
        if len(parts) != 2:
            raise ValueError
        d, m = int(parts[0]), int(parts[1])
        if d < 1 or m < 1:
            raise ValueError
    except ValueError:
        raise ValueError(
            f"mesh must be 'DATAxMODEL' with positive ints, got {s!r}"
        ) from None
    return d, m


@dataclass(frozen=True)
class IndexSpec:
    """Every knob of a FERRARI build + serving engine, validated.

    Build knobs (paper §4.2/§4.3): ``k`` is the per-node interval budget
    (FERRARI-L) or the global-budget divisor B = k·n (FERRARI-G);
    ``variant="full"`` is the k=∞ Interval baseline and requires ``k=None``.
    Engine knobs mirror ``DeviceQueryEngine``; session knobs govern
    ``QuerySession`` micro-batching (batches are padded up to power-of-two
    buckets in [min_bucket, max_batch] so ragged tails never retrace).
    """
    # ----------------------------------------------------- build (paper §4)
    k: Optional[int] = 2
    variant: str = "G"
    c: int = 4                      # FERRARI-G slack factor (§4.3, c·k)
    cover_method: str = "greedy"
    n_seeds: int = 32
    use_seeds: bool = True
    precondensed: bool = False
    # --------------------------------------- builder (DESIGN.md §2 pipeline)
    builder: str = "host"           # host sweep | wavefront device pipeline
    merge_chunk: int = 64           # tree-reduction fan-in per merge round
    m_cap: Optional[int] = None     # max merge working width (slots); None
    #                                 keeps fan-in <= SINGLE_SHOT_DEG on the
    #                                 bit-identical single-shot path
    # ------------------------------------------------- engine (phase 1 + 2)
    phase2_mode: str = "auto"
    n_dense_max: int = 8192
    ell_width: Optional[int] = None
    phase2_chunk: int = 256
    use_pallas: bool = True
    frontier_cap: int = 4096
    frontier_cap_max: int = 1 << 18
    # kept for manifest round-trips with the reference package; here the
    # device alone decides (CUDA kernels on a card, plain versions on the
    # CPU), and "xla" / use_pallas=False are refused on a card
    kernel_impl: str = "auto"
    # ------------------------------------------------- session micro-batch
    max_batch: int = 16384
    min_bucket: int = 256
    # -------------------------------------- live updates (DESIGN.md §6)
    overlay_cap: int = 4096         # delta edges held before compaction
    auto_compact: bool = True       # compact() when an insert needs room
    compact_mode: str = "auto"      # auto | incremental | full
    # -------------------------------------------- placement (DESIGN.md §3.6)
    placement: str = "single"       # single | replicated | sharded
    mesh: Optional[str] = None      # "DATAxMODEL", e.g. "2x4"; None = default
    # ------------------------------------- async frontend (DESIGN.md §7)
    deadline_us: int = 500          # per-tenant coalescing deadline
    tenant_queue_cap: int = 8192    # pending queries per tenant queue
    cache_entries: int = 65536      # epoch-keyed answer cache; 0 disables
    latency_window: int = 1 << 16   # per-tenant latency reservoir size

    # ------------------------------------------------------------ validate
    def __post_init__(self):
        if self.variant not in VARIANTS:
            raise ValueError(f"variant must be one of {VARIANTS}, "
                             f"got {self.variant!r}")
        if self.variant == "full":
            if self.k is not None:
                raise ValueError("variant='full' is the k=∞ baseline; "
                                 "it requires k=None")
        else:
            if self.k is None:
                raise ValueError("k=None (unbounded) requires variant='full'")
            if self.k < 1:
                raise ValueError(f"k must be >= 1, got {self.k}")
        if self.c < 1:
            raise ValueError(f"c must be >= 1, got {self.c}")
        if self.cover_method not in COVER_METHODS:
            raise ValueError(f"cover_method must be one of {COVER_METHODS}, "
                             f"got {self.cover_method!r}")
        if self.use_seeds and self.n_seeds < 1:
            raise ValueError("use_seeds=True requires n_seeds >= 1")
        if self.builder not in BUILDERS:
            raise ValueError(f"builder must be one of {BUILDERS}, "
                             f"got {self.builder!r}")
        if self.merge_chunk < 2:
            raise ValueError("merge_chunk must be >= 2 (the tree reduction "
                             "must shrink the partial count every round)")
        if self.builder == "wavefront":
            if self.variant == "full":
                raise ValueError("builder='wavefront' supports variants "
                                 "'L'/'G'; the k=None full baseline is "
                                 "host-only")
            if self.cover_method != "topgap":
                raise ValueError("builder='wavefront' covers with the "
                                 "one-sort 'topgap' method only, got "
                                 f"{self.cover_method!r}")
            # m_cap must admit chunks of >= 2 rows at this slab width
            w_out = self.k if self.variant == "L" else self.c * self.k
            if self.m_cap is not None and self.m_cap < 2 * w_out + 1:
                raise ValueError(
                    f"m_cap={self.m_cap} is narrower than two slab rows + "
                    f"the tree interval at width W={w_out}; need >= "
                    f"{2 * w_out + 1}")
        elif self.m_cap is not None and self.m_cap < 3:
            raise ValueError(f"m_cap must be >= 3, got {self.m_cap}")
        if self.kernel_impl not in KERNEL_IMPLS:
            raise ValueError(f"kernel_impl must be one of {KERNEL_IMPLS}, "
                             f"got {self.kernel_impl!r}")
        if self.phase2_mode not in PHASE2_MODES:
            raise ValueError(f"phase2_mode must be one of {PHASE2_MODES}, "
                             f"got {self.phase2_mode!r}")
        if self.n_dense_max < 1:
            raise ValueError("n_dense_max must be >= 1")
        if self.ell_width is not None and self.ell_width < 1:
            raise ValueError("ell_width must be >= 1 (or None for auto)")
        if self.phase2_chunk < 1:
            raise ValueError("phase2_chunk must be >= 1")
        if self.frontier_cap < 1:
            raise ValueError("frontier_cap must be >= 1")
        if self.frontier_cap_max < self.frontier_cap:
            raise ValueError("frontier_cap_max must be >= frontier_cap")
        if self.min_bucket < 1:
            raise ValueError("min_bucket must be >= 1")
        if self.max_batch < self.min_bucket:
            raise ValueError("max_batch must be >= min_bucket")
        if self.overlay_cap < 1:
            raise ValueError("overlay_cap must be >= 1")
        if self.compact_mode not in COMPACT_MODES:
            raise ValueError(f"compact_mode must be one of {COMPACT_MODES}, "
                             f"got {self.compact_mode!r}")
        if self.deadline_us < 1:
            raise ValueError("deadline_us must be >= 1")
        if self.tenant_queue_cap < 1:
            raise ValueError("tenant_queue_cap must be >= 1")
        if self.cache_entries < 0:
            raise ValueError("cache_entries must be >= 0 (0 disables)")
        if self.latency_window < 1:
            raise ValueError("latency_window must be >= 1 (the percentile "
                             "reservoir needs at least one slot)")
        if self.placement not in PLACEMENTS:
            raise ValueError(f"placement must be one of {PLACEMENTS}, "
                             f"got {self.placement!r}")
        if self.placement == "single":
            if self.mesh is not None:
                raise ValueError("mesh requires placement='replicated' "
                                 "or 'sharded'")
        else:
            if self.phase2_mode == "dense":
                raise ValueError("phase2_mode='dense' is single-device "
                                 "only (n×n adjacency); use sparse or host")
            if self.mesh is not None:
                d, m = parse_mesh(self.mesh)     # raises on bad format
                if self.placement == "replicated" and m != 1:
                    raise ValueError(
                        "replicated placement holds whole tables per "
                        "device: mesh model axis must be 1, got "
                        f"{self.mesh!r}")

    # -------------------------------------------------- dict serialization
    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "IndexSpec":
        known = {f.name for f in fields(cls)}
        unknown = set(d) - known
        if unknown:
            raise ValueError(f"unknown IndexSpec fields: {sorted(unknown)}")
        return cls(**d)

    @classmethod
    def from_config(cls, cfg, **overrides) -> "IndexSpec":
        """Derive a spec from a ``configs.base.FerrariServeConfig``.

        ``k_max`` is the packed slab width ≈ c·k under FERRARI-G slack, so
        k = max(1, k_max // c); ``seed_words`` (uint32 words per direction)
        gives n_seeds = 32·words. Any kwarg overrides the derived value.
        """
        c = overrides.get("c", cls.c)
        derived = {}
        if getattr(cfg, "k_max", None) is not None:
            derived["k"] = max(1, int(cfg.k_max) // c)
        if getattr(cfg, "seed_words", None) is not None:
            derived["n_seeds"] = 32 * int(cfg.seed_words)
        derived.update(overrides)
        return cls(**derived)

    # --------------------------------------------------- CLI serialization
    @staticmethod
    def add_cli_args(ap: argparse.ArgumentParser) -> None:
        """Register every spec knob on an argparse parser (defaults = the
        dataclass defaults, so ``from_args`` of an empty argv == IndexSpec())."""
        d = IndexSpec()
        ap.add_argument("--k", type=int, default=d.k,
                        help="interval budget per node (paper §4); "
                             "ignored for --variant full")
        ap.add_argument("--variant", default=d.variant, choices=VARIANTS,
                        help="L = local budget, G = global budget, "
                             "full = k=∞ Interval baseline")
        ap.add_argument("--c", type=int, default=d.c,
                        help="FERRARI-G slack factor (cover to c*k first)")
        ap.add_argument("--cover-method", default=d.cover_method,
                        choices=COVER_METHODS)
        ap.add_argument("--n-seeds", type=int, default=d.n_seeds)
        ap.add_argument("--no-seeds", action="store_true",
                        help="disable seed labels (§5.1)")
        ap.add_argument("--precondensed", action="store_true",
                        help="input is already a DAG: skip Tarjan")
        ap.add_argument("--builder", default=d.builder, choices=BUILDERS,
                        help="host = paper-faithful sweep; wavefront = "
                             "staged device pipeline (requires "
                             "--cover-method topgap)")
        ap.add_argument("--merge-chunk", type=int, default=d.merge_chunk,
                        help="tree-reduction merge fan-in per round "
                             "(wavefront builder, DESIGN.md §2)")
        ap.add_argument("--m-cap", type=int, default=d.m_cap,
                        help="max merge working width in interval slots "
                             "(default: fan-in up to 256 children merges "
                             "single-shot, hubs above tree-reduce)")
        ap.add_argument("--phase2", default=d.phase2_mode,
                        choices=PHASE2_MODES, dest="phase2_mode",
                        help="phase-2 engine: auto = dense for n <= "
                             "dense-max, sparse ELL frontier above")
        ap.add_argument("--dense-max", type=int, default=d.n_dense_max,
                        dest="n_dense_max")
        ap.add_argument("--ell-width", type=int, default=d.ell_width,
                        help="ELL slab width (default min(max_out_deg, 32))")
        ap.add_argument("--phase2-chunk", type=int, default=d.phase2_chunk)
        ap.add_argument("--no-pallas", action="store_true",
                        help="kept for spec round-trips; refused on a "
                             "CUDA device")
        ap.add_argument("--frontier-cap", type=int, default=d.frontier_cap)
        ap.add_argument("--frontier-cap-max", type=int,
                        default=d.frontier_cap_max)
        ap.add_argument("--kernel-impl", default=d.kernel_impl,
                        choices=KERNEL_IMPLS, dest="kernel_impl",
                        help="kept for spec round-trips; 'xla' is "
                             "refused on a CUDA device")
        ap.add_argument("--max-batch", type=int, default=d.max_batch,
                        help="QuerySession micro-batch ceiling")
        ap.add_argument("--min-bucket", type=int, default=d.min_bucket,
                        help="smallest power-of-two padding bucket")
        ap.add_argument("--overlay-cap", type=int, default=d.overlay_cap,
                        help="delta-overlay slab capacity: edge inserts "
                             "held beside the index before compaction "
                             "(DESIGN.md §6)")
        ap.add_argument("--no-auto-compact", action="store_true",
                        help="raise instead of compacting when an insert "
                             "exceeds the overlay capacity")
        ap.add_argument("--compact-mode", default=d.compact_mode,
                        choices=COMPACT_MODES,
                        help="auto = bounded incremental relabeling with "
                             "full-rebuild fallback on cycle-closing "
                             "inserts")
        ap.add_argument("--placement", default=d.placement,
                        choices=PLACEMENTS,
                        help="index placement: single device, replicated "
                             "(queries shard, zero collectives) or sharded "
                             "(table rows shard over the model axis)")
        ap.add_argument("--mesh", default=d.mesh, metavar="DATAxMODEL",
                        help="serving mesh shape, e.g. 2x4 (default: all "
                             "devices on one axis per --placement)")
        ap.add_argument("--deadline-us", type=int, default=d.deadline_us,
                        dest="deadline_us",
                        help="frontend coalescing deadline per tenant: a "
                             "queue drains when a batch bucket fills OR "
                             "its oldest request ages past this "
                             "(DESIGN.md §7)")
        ap.add_argument("--tenant-queue-cap", type=int,
                        default=d.tenant_queue_cap, dest="tenant_queue_cap",
                        help="pending-query bound per tenant queue; "
                             "admission rejects past it (backpressure)")
        ap.add_argument("--cache", type=int, default=d.cache_entries,
                        dest="cache_entries", metavar="ENTRIES",
                        help="epoch-keyed (epoch, u, v) answer-cache "
                             "capacity; 0 disables")
        ap.add_argument("--latency-window", type=int,
                        default=d.latency_window, dest="latency_window",
                        help="per-tenant latency reservoir size backing "
                             "the frontend's p50/p99 (bounded memory "
                             "under long-running serving)")

    @classmethod
    def from_args(cls, args: argparse.Namespace) -> "IndexSpec":
        variant = args.variant
        return cls(
            k=(None if variant == "full" else args.k),
            variant=variant,
            c=args.c,
            cover_method=args.cover_method,
            n_seeds=args.n_seeds,
            use_seeds=not args.no_seeds,
            precondensed=args.precondensed,
            builder=args.builder,
            merge_chunk=args.merge_chunk,
            m_cap=args.m_cap,
            phase2_mode=args.phase2_mode,
            n_dense_max=args.n_dense_max,
            ell_width=args.ell_width,
            phase2_chunk=args.phase2_chunk,
            use_pallas=not args.no_pallas,
            frontier_cap=args.frontier_cap,
            frontier_cap_max=args.frontier_cap_max,
            kernel_impl=args.kernel_impl,
            max_batch=args.max_batch,
            min_bucket=args.min_bucket,
            overlay_cap=args.overlay_cap,
            auto_compact=not args.no_auto_compact,
            compact_mode=args.compact_mode,
            placement=args.placement,
            mesh=args.mesh,
            deadline_us=args.deadline_us,
            tenant_queue_cap=args.tenant_queue_cap,
            cache_entries=args.cache_entries,
            latency_window=args.latency_window,
        )

    def to_cli_args(self) -> list:
        """Inverse of ``from_args``: an argv that parses back to ``self``."""
        argv = ["--variant", self.variant]
        if self.variant != "full":
            argv += ["--k", str(self.k)]
        argv += ["--c", str(self.c), "--cover-method", self.cover_method,
                 "--n-seeds", str(self.n_seeds)]
        if not self.use_seeds:
            argv.append("--no-seeds")
        if self.precondensed:
            argv.append("--precondensed")
        argv += ["--builder", self.builder,
                 "--merge-chunk", str(self.merge_chunk)]
        if self.m_cap is not None:
            argv += ["--m-cap", str(self.m_cap)]
        argv += ["--phase2", self.phase2_mode,
                 "--dense-max", str(self.n_dense_max)]
        if self.ell_width is not None:
            argv += ["--ell-width", str(self.ell_width)]
        argv += ["--phase2-chunk", str(self.phase2_chunk)]
        if not self.use_pallas:
            argv.append("--no-pallas")
        argv += ["--frontier-cap", str(self.frontier_cap),
                 "--frontier-cap-max", str(self.frontier_cap_max),
                 "--kernel-impl", self.kernel_impl,
                 "--max-batch", str(self.max_batch),
                 "--min-bucket", str(self.min_bucket),
                 "--overlay-cap", str(self.overlay_cap)]
        if not self.auto_compact:
            argv.append("--no-auto-compact")
        argv += ["--compact-mode", self.compact_mode,
                 "--placement", self.placement]
        if self.mesh is not None:
            argv += ["--mesh", self.mesh]
        argv += ["--deadline-us", str(self.deadline_us),
                 "--tenant-queue-cap", str(self.tenant_queue_cap),
                 "--cache", str(self.cache_entries),
                 "--latency-window", str(self.latency_window)]
        return argv


# ---------------------------------------------------------------- facade --

def _refuse_plain_path(spec: IndexSpec, dev) -> None:
    """On a CUDA device the port runs its CUDA kernels only."""
    if dev.type == "cuda" and (spec.kernel_impl == "xla"
                               or not spec.use_pallas):
        raise ValueError(
            "on a CUDA device the port runs its CUDA kernels only; "
            f"kernel_impl={spec.kernel_impl!r}, use_pallas={spec.use_pallas} "
            "asks for a path it does not have")


def build(g, spec: IndexSpec = IndexSpec(), device="cuda"):
    """Build a :class:`~repro_torch.core.ferrari.FerrariIndex` from a spec.

    ``spec.builder`` picks the constructor: ``"host"`` is the
    paper-faithful numpy sweep (``core.ferrari.build_index``; ``device``
    is not used); ``"wavefront"`` is the staged device pipeline
    (``core.build.build_index_device``) on ``device`` — per-level-sized
    wave merges plus the chunked tree reduction for hub fan-in, through
    kernel 5 on a card — governed by ``merge_chunk`` / ``m_cap``.
    """
    if spec.builder == "wavefront":
        from ..core.build import build_index_device
        from ..core.query_torch import resolve_device
        dev = resolve_device(device)
        _refuse_plain_path(spec, dev)
        return build_index_device(
            g, k=spec.k, variant=spec.variant, c=spec.c,
            cover_method=spec.cover_method, n_seeds=spec.n_seeds,
            use_seeds=spec.use_seeds, precondensed=spec.precondensed,
            merge_chunk=spec.merge_chunk, m_cap=spec.m_cap, device=dev)
    from ..core.ferrari import build_index
    variant = "G" if spec.variant == "full" else spec.variant
    return build_index(g, k=spec.k, variant=variant, c=spec.c,
                       cover_method=spec.cover_method, n_seeds=spec.n_seeds,
                       use_seeds=spec.use_seeds,
                       precondensed=spec.precondensed)


def make_engine(index, spec: IndexSpec = IndexSpec(), *, packed=None,
                ell=None, device="cuda", mesh=None):
    """Construct the two-phase engine described by ``spec`` on ``device``
    (see ``core.query_torch.resolve_device``).

    ``spec.placement`` picks the executor: ``"single"`` is the one-device
    ``DeviceQueryEngine``; ``"replicated"`` / ``"sharded"`` build a
    ``core.distributed.DistributedQueryEngine`` over the process group's
    (data, model) mesh (``spec.mesh``, default every rank on one axis;
    "cuda" names the current card, which the caller sets to the rank's) —
    same interface, the same answers. It raises without an initialised
    process group or when the mesh does not match its world. ``mesh``: a
    ``ServingMesh`` to reuse instead. ``packed`` / ``ell`` inject
    pre-built layouts to skip the host packing loops."""
    from ..core.query_torch import DeviceQueryEngine, resolve_device
    common = dict(
        n_dense_max=spec.n_dense_max, phase2_chunk=spec.phase2_chunk,
        phase2_mode=spec.phase2_mode, ell_width=spec.ell_width,
        frontier_cap=spec.frontier_cap,
        frontier_cap_max=spec.frontier_cap_max, packed=packed, ell=ell,
        overlay_cap=spec.overlay_cap)
    if spec.placement == "single":
        dev = resolve_device(device)
        _refuse_plain_path(spec, dev)
        return DeviceQueryEngine(index, device=dev, **common)
    from ..core.distributed import DistributedQueryEngine, ServingMesh
    if mesh is None:
        shape = None if spec.mesh is None else parse_mesh(spec.mesh)
        mesh = ServingMesh(spec.placement, shape, device)
    _refuse_plain_path(spec, mesh.device)
    return DistributedQueryEngine(index, mesh, **common)
