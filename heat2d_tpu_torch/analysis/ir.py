"""IR verifier: footprint, dtype-flow and collective contracts for every
registered program. The port's counterpart of
``heat2d_tpu/analysis/ir.py`` (which walks jaxprs).

The problem registry declares each family's spatial operator
(``FamilySpec``: ``halo_width``, ``reads_per_step``, ``kernel_routes``,
``cast_allowlist``) and the sharded path declares its communication
(``parallel.sharded.COLLECTIVE_CONTRACT``). Three passes hold the
declarations to the programs, all on the host:

1. **Footprint** (``analysis/footprint.py``): the offset-interval
   interpreter derives each step's access radius from its aten graph
   (``make_fx`` on CPU tensors) and checks it against ``halo_width`` on
   every axis, for every family's plain step and ``ops/stencil.
   stencil_step``; its coefficient-read count checks ``reads_per_step``,
   and the roofline's bytes per cell-step of the jnp route
   (``obs/roofline.analytic_bytes_per_cell_step``). The band-strip
   witness checks the tile plans the streamed kernels sweep
   (``ops/cuda_ensemble.tile_plan`` for H6, ``ops/cuda_family.
   tile_plan`` for H9): a ring of ``halo_width * tsteps``.
2. **Dtype-flow** (``analysis/dtype_flow.py``): a precision card per
   batch route's plain program lists every cast with its provenance;
   precision-relevant casts off the family's ``cast_allowlist`` are
   findings.
3. **Collective contract**: the census of a sharded program (the
   exchange and the residual sum are host code, which a recording shim
   counts while the program runs on CPU slots) against
   ``COLLECTIVE_CONTRACT``: 4 nearest-neighbour strip shifts an
   exchange, the residual sum only in convergence programs, no gather,
   and no exchange outside H14 on tier ``ici``; and every batch program
   exchanges and reduces nothing.

The hand kernels are CUDA C++, which no graph sees: what is traced here
is each route's plain PyTorch version (the CPU tensors make every
wrapper take it). ``chip_smoke.py`` holds every kernel to its plain
version bit for bit on the card, so the footprints, casts and exchanges
checked here are the kernels' too.

``verify_all`` sweeps every registered (family x route) program plus the
dist2d sharded programs on a 2x2 of ``host_devices(4, 'cpu')`` slots
(both ``--halo`` routes, fixed and convergence) and hybrid ``--halo
fused`` (tier ``ici``); ``heat2d-tpu-torch-lint --ir`` runs it and
exits 1 on any finding, and ``tests/test_torch_ir.py`` seeds a violation
for each pass.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

from heat2d_tpu_torch.analysis.dtype_flow import (CollectiveCensus,
                                                  PrecisionCard, census_casts,
                                                  record_collectives)
from heat2d_tpu_torch.analysis.footprint import derive_footprint, trace

PASS_FOOTPRINT = "footprint"
PASS_DTYPE = "dtype-flow"
PASS_COLLECTIVE = "collective"


@dataclasses.dataclass(frozen=True)
class IrFinding:
    """One contract violation in one program."""

    pass_name: str
    program: str
    message: str

    def describe(self) -> str:
        return f"[{self.pass_name}] {self.program}: {self.message}"


@dataclasses.dataclass
class IrReport:
    """The sweep's output: findings (empty: the gate passes) and the
    derived-against-declared rows the CLI renders."""

    findings: List[IrFinding] = dataclasses.field(default_factory=list)
    #: program, declared w, derived radii, witness, derived reads
    footprint_rows: List[dict] = dataclasses.field(default_factory=list)
    cards: List[PrecisionCard] = dataclasses.field(default_factory=list)
    #: program, census summary
    collective_rows: List[dict] = dataclasses.field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.findings

    def merge(self, other: "IrReport") -> None:
        self.findings.extend(other.findings)
        self.footprint_rows.extend(other.footprint_rows)
        self.cards.extend(other.cards)
        self.collective_rows.extend(other.collective_rows)


# --------------------------------------------------------------------- #
# The passes' building blocks: each takes a program or its census, so
# the seeded-violation tests drive them on broken programs directly
# --------------------------------------------------------------------- #

def check_kernel_footprint(program: str, fn: Callable, u,
                           declared_width: int,
                           declared_reads: Optional[int] = None
                           ) -> Tuple[List[IrFinding], dict]:
    """Derive ``fn``'s footprint on the state tensor ``u`` (on the CPU)
    and compare it to the declared halo width and, when given,
    reads_per_step."""
    findings: List[IrFinding] = []
    fp = derive_footprint(fn, u)
    row = {"program": program, "declared_width": declared_width,
           "derived": None, "witness": None, "derived_reads": None,
           "declared_reads": declared_reads}
    if not fp.derivable:
        findings.append(IrFinding(
            PASS_FOOTPRINT, program,
            f"footprint underivable: op {fp.top!r} escapes the "
            f"offset-interval domain (declared halo_width="
            f"{declared_width})"))
        return findings, row
    radii = fp.radii()
    row["derived"] = radii
    row["witness"] = tuple(fp.witness(a) for a in range(len(radii)))
    for axis, r in enumerate(radii):
        if r != declared_width:
            findings.append(IrFinding(
                PASS_FOOTPRINT, program,
                f"axis {axis}: derived access radius {r} != declared "
                f"halo_width {declared_width} (offsets "
                f"[{fp.lo[axis]}, {fp.hi[axis]}], widened by "
                f"op {fp.witness(axis)!r})"))
    derived_reads = 1 + fp.coef_reads
    row["derived_reads"] = derived_reads
    if declared_reads is not None and derived_reads != declared_reads:
        findings.append(IrFinding(
            PASS_FOOTPRINT, program,
            f"derived HBM reads/step {derived_reads} (state + "
            f"{fp.coef_reads} coefficient field(s)) != declared "
            f"reads_per_step {declared_reads}"))
    return findings, row


def check_band_strips(program: str, plan, expected_ring: int,
                      halo_width: int) -> List[IrFinding]:
    """The band routes' halo witness: the tile plan a streamed kernel
    sweeps (``cuda_stencil.TilePlan``, whose ``tsteps`` is the ring depth
    every tile recomputes) carries a ring of ``halo_width * tsteps``."""
    if plan.tsteps != expected_ring:
        return [IrFinding(
            PASS_FOOTPRINT, program,
            f"tile plan ships a {plan.tsteps}-deep ring, but the sweep "
            f"requires halo_width*tsteps = {expected_ring} (halo_width "
            f"{halo_width})")]
    return []


def check_dtypes(program: str, gm,
                 allowlist: Sequence[Tuple[str, str]] = ()
                 ) -> Tuple[List[IrFinding], PrecisionCard]:
    """Precision card of the traced graph ``gm``, and findings for casts
    outside the allowlist."""
    card = PrecisionCard(program=program, casts=census_casts(gm))
    findings = [
        IrFinding(PASS_DTYPE, program,
                  f"undeclared cast {c.describe()} — declare it in the "
                  f"family's cast_allowlist or remove it")
        for c in card.findings(allowlist)]
    return findings, card


def _distance(pair) -> int:
    (si, sj), (i, j) = pair
    return abs(si - i) + abs(sj - j)


def check_collectives(program: str, census: CollectiveCensus,
                      contract: dict, require_exchange: bool = True,
                      convergence: Optional[bool] = None,
                      tier: Optional[str] = None
                      ) -> Tuple[List[IrFinding], dict]:
    """Check a sharded program's census against the declared contract
    (``parallel.sharded.COLLECTIVE_CONTRACT``). ``convergence``: when
    given, the residual sum must appear iff it is True. ``tier``: a tier
    of ``no_exchange_tiers`` must exchange no strip outside its kernel
    (and need not exchange at all)."""
    findings: List[IrFinding] = []
    per_exchange = contract["shifts_per_exchange"]
    dist = contract["neighbor_distance"]
    nested = contract["nested"]
    no_exchange = tier in contract.get("no_exchange_tiers", ())
    for s in census.sites:
        parent = s.path[-1] if s.path else None
        if parent is not None and s.prim in nested.get(parent, ()):
            pass
        elif s.prim in contract["forbidden"]:
            findings.append(IrFinding(
                PASS_COLLECTIVE, program,
                f"forbidden collective {s.describe()} — the halo contract "
                f"moves O(halo) bytes by strip shifts only; a {s.prim} "
                f"moves O(grid) bytes per step"))
            continue
        elif s.prim not in contract["allowed"] or parent is not None:
            findings.append(IrFinding(
                PASS_COLLECTIVE, program,
                f"undeclared collective {s.describe()} (allowed: "
                f"{contract['allowed']})"))
            continue
        if s.prim == "strip_shift":
            for pair in s.perms:
                if _distance(pair) != dist:
                    findings.append(IrFinding(
                        PASS_COLLECTIVE, program,
                        f"strip shift {pair[0]} -> {pair[1]} is not a "
                        f"nearest-neighbor shift (|src-dst| != {dist})"))
    exchanges = census.count("exchange")
    shifts = census.count("strip_shift", ("exchange",))
    if shifts != per_exchange * exchanges:
        findings.append(IrFinding(
            PASS_COLLECTIVE, program,
            f"{shifts} strip shift(s) over {exchanges} exchange(s): not "
            f"the {per_exchange}-shift exchange"))
    if no_exchange and exchanges:
        findings.append(IrFinding(
            PASS_COLLECTIVE, program,
            f"tier {tier!r} exchanged strips outside its kernel "
            f"({exchanges} exchange(s))"))
    elif require_exchange and not no_exchange and exchanges == 0:
        findings.append(IrFinding(
            PASS_COLLECTIVE, program,
            "no strip halo exchange found in the recorded sharded "
            "program"))
    sums = census.count("allreduce")
    if convergence is False and sums:
        findings.append(IrFinding(
            PASS_COLLECTIVE, program,
            f"residual all-reduce ×{sums} in a fixed-step program"))
    if convergence is True and not sums:
        findings.append(IrFinding(
            PASS_COLLECTIVE, program,
            "no residual all-reduce in a convergence program"))
    row = {"program": program,
           "census": [s.describe() for s in census.sites],
           "exchanges": exchanges, "shifts": shifts}
    return findings, row


def check_no_collectives(program: str, census: CollectiveCensus
                         ) -> Tuple[List[IrFinding], dict]:
    """Single-device batch programs exchange and reduce nothing."""
    findings = [
        IrFinding(PASS_COLLECTIVE, program,
                  f"unexpected collective {s.describe()} in a non-sharded "
                  f"batch program")
        for s in census.sites]
    return findings, {"program": program,
                      "census": [s.describe() for s in census.sites],
                      "exchanges": 0, "shifts": 0}


# --------------------------------------------------------------------- #
# The registry sweep
# --------------------------------------------------------------------- #

_CX, _CY = 0.1, 0.1

#: steps of a traced batch program on the routes without a sweep depth
_BATCH_STEPS = 8


def _band_plan(name: str, nx: int, ny: int):
    """(plan, tsteps) of the band route's streamed kernel on the CPU (the
    H100's plan): H6 for heat5, H9 for the other families."""
    from heat2d_tpu_torch.ops import cuda_ensemble as ce
    from heat2d_tpu_torch.ops import cuda_family as cf
    if name == "heat5":
        t = ce.DEFAULT_TSTEPS
        return ce.tile_plan(nx, ny, "cpu", tsteps=t), t
    t = cf.SWEEP_TSTEPS.get(name, cf.DEFAULT_TSTEPS)
    return cf.tile_plan(nx, ny, name, "cpu", tsteps=t), t


def _verify_stencil_step(nx: int, ny: int) -> IrReport:
    import torch

    from heat2d_tpu_torch.ops.stencil import stencil_step
    from heat2d_tpu_torch.problems.base import spec_for
    rep = IrReport()
    spec = spec_for("heat5")
    f, row = check_kernel_footprint(
        "stencil_step", lambda v: stencil_step(v, _CX, _CY),
        torch.zeros(nx, ny), spec.halo_width,
        declared_reads=spec.reads_per_step)
    rep.findings.extend(f)
    rep.footprint_rows.append(row)
    return rep


def _verify_family(name: str, nx: int, ny: int, batch: int) -> IrReport:
    import torch

    from heat2d_tpu_torch.obs.roofline import analytic_bytes_per_cell_step
    from heat2d_tpu_torch.problems.registry import get_family
    from heat2d_tpu_torch.problems.runners import fixed_runner

    rep = IrReport()
    fam = get_family(name)
    spec = fam.spec
    w = spec.halo_width
    u = torch.zeros(nx, ny)

    # the plain step: radius and the reads witness
    f, row = check_kernel_footprint(
        f"{name}/step", lambda v: fam.step(v, _CX, _CY), u, w,
        declared_reads=spec.reads_per_step)
    rep.findings.extend(f)
    rep.footprint_rows.append(row)

    # roofline cross-check: the jnp route's stream counts exactly the
    # derived operands (+1 write)
    if row["derived_reads"] is not None and "jnp" in spec.kernel_routes:
        model = analytic_bytes_per_cell_step(nx, ny, method="jnp",
                                             problem=name, device="cpu")
        expect = (row["derived_reads"] + 1) * 4.0      # float32
        if model["bytes_per_cell_step"] != expect:
            rep.findings.append(IrFinding(
                PASS_FOOTPRINT, f"{name}/roofline",
                f"roofline jnp model streams "
                f"{model['bytes_per_cell_step']}B/cell-step but the "
                f"derived operand count implies {expect}B "
                f"({row['derived_reads']} reads + 1 write)"))

    # every route's plain batch program: precision card, no exchange
    u0 = torch.zeros(batch, nx, ny)
    cs = torch.full((batch,), _CX)
    for route in spec.kernel_routes:
        run = fixed_runner(name, route)
        steps = _BATCH_STEPS
        if route == "band":
            plan, steps = _band_plan(name, nx, ny)
        gm, census = record_collectives(
            trace, lambda a, b, c: run(a, b, c, steps=steps), u0, cs, cs)
        prog = f"{name}/{route}"
        f, card = check_dtypes(prog, gm, spec.cast_allowlist)
        rep.findings.extend(f)
        rep.cards.append(card)
        f, crow = check_no_collectives(prog, census)
        rep.findings.extend(f)
        rep.collective_rows.append(crow)
        if route == "band":
            rep.findings.extend(check_band_strips(prog, plan, w * steps, w))
    return rep


def _verify_sharded(nx: int, ny: int) -> IrReport:
    from heat2d_tpu_torch.config import HeatConfig
    from heat2d_tpu_torch.parallel.mesh import host_devices, make_mesh
    from heat2d_tpu_torch.parallel.sharded import (COLLECTIVE_CONTRACT,
                                                   make_sharded_runner,
                                                   resolve_halo_route,
                                                   sharded_inidat)
    rep = IrReport()
    mesh = make_mesh(2, 2, host_devices(4, "cpu"))
    programs = [("dist2d", halo, conv) for halo in ("collective", "fused")
                for conv in (False, True)] + [("hybrid", "fused", False)]
    for mode, halo, conv in programs:
        cfg = HeatConfig(nxprob=nx, nyprob=ny, steps=12, mode=mode,
                         gridx=2, gridy=2, halo_depth=3, halo=halo,
                         convergence=conv, interval=4, sensitivity=0.0)
        kernel = mode == "hybrid"
        tier = resolve_halo_route(cfg, mesh, kernel)["tier"]
        runner = make_sharded_runner(cfg, mesh, kernel)
        _, census = record_collectives(runner, sharded_inidat(cfg, mesh))
        prog = (f"sharded/{halo}[{tier}]/{'conv' if conv else 'fixed'}")
        f, crow = check_collectives(prog, census, COLLECTIVE_CONTRACT,
                                    convergence=conv, tier=tier)
        rep.findings.extend(f)
        rep.collective_rows.append(crow)
    return rep


def verify_all(nx: int = 32, ny: int = 64, batch: int = 2,
               include_sharded: bool = True) -> IrReport:
    """The full IR gate: ``stencil_step``, every registered family's step
    and (family x route) batch program, and the sharded programs on CPU
    slots. Zero findings: the declared contracts match the programs."""
    from heat2d_tpu_torch.problems.registry import family_names
    rep = _verify_stencil_step(nx, ny)
    for name in family_names():
        rep.merge(_verify_family(name, nx, ny, batch))
    if include_sharded:
        rep.merge(_verify_sharded(48, 48))
    return rep


def render_report(rep: IrReport, verbose: bool = False) -> str:
    """The CLI's rendering."""
    lines: List[str] = []
    lines.append("IR verification "
                 f"({len(rep.footprint_rows)} footprint rows, "
                 f"{len(rep.cards)} precision cards, "
                 f"{len(rep.collective_rows)} collective censuses)")
    for row in rep.footprint_rows:
        derived = (f"radii {row['derived']}" if row["derived"]
                   else "underivable")
        reads = ""
        if row["derived_reads"] is not None and \
                row["declared_reads"] is not None:
            reads = (f", reads {row['derived_reads']} "
                     f"(declared {row['declared_reads']})")
        lines.append(f"  {row['program']}: declared w="
                     f"{row['declared_width']}, derived {derived}{reads}")
    if verbose:
        for card in rep.cards:
            lines.extend("  " + ln for ln in card.lines())
        for row in rep.collective_rows:
            census = "; ".join(row["census"]) or "none"
            lines.append(f"  {row['program']}: collectives: {census}")
    if rep.findings:
        lines.append(f"{len(rep.findings)} IR finding(s):")
        lines.extend("  " + f.describe() for f in rep.findings)
    else:
        lines.append("no IR findings — declared contracts match the "
                     "traced programs")
    return "\n".join(lines)
