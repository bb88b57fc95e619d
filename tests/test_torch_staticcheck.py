"""``repro_torch.staticcheck`` against ``repro.staticcheck``, case for case
with ``tests/test_staticcheck.py``: every AST rule fires exactly once on a
seeded violation (the reference's fixtures rewritten in torch) and stays
silent on the compliant variants, with the reference's verdicts; the
clean tree of ``src/repro_torch`` has no finding; the op rules measure
what the reference's jaxpr rules measure on the same toy functions; one
registered op audit per entry point (parametrized, on the CPU); and the
CLI's exit-code / JSON-report contract.

The reference's R2 guards ``jax.jit`` around ``shard_map``, which the port
does not have: the port has no R2, and its fixtures stay silent here.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import test_staticcheck as ref_fixtures  # noqa: E402
from repro import staticcheck as ref  # noqa: E402
from repro_torch.core.mesh import ShardMesh  # noqa: E402
from repro_torch.staticcheck import (REGISTERED_AUDITS,  # noqa: E402
                                     RULES, assert_no_host_transfers,
                                     audit_ops, bounded_recompiles,
                                     count_compile_signatures, lint_paths,
                                     lint_source, max_intermediate_elems,
                                     no_dense_intermediate, no_host_transfer,
                                     trace_ops)
from repro_torch.staticcheck import __main__ as cli  # noqa: E402
from repro_torch.staticcheck import registry  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC_PORT = os.path.join(REPO, "src", "repro_torch")


# --- AST rules: one seeded violation each, compliant twins stay silent -------

_R1_BAD = """
import torch
def bad_walk(bvh, q):
    node = torch.zeros(q.shape[0], dtype=torch.long)
    acc = torch.zeros(q.shape[0])
    while bool((node != -1).any()):
        acc = acc + bvh.node_lo[node].sum(1)
        node = bvh.rope[node]
    return acc
"""

_R1_OK_UNION_FIND = """
import torch
def union_fixpoint(parent):
    while True:
        p2 = torch.minimum(parent, parent[parent])
        if not bool((p2 != parent).any()):
            return p2
        parent = p2
"""

# Rotary embeddings: ``L.rope(...)`` is a call, not a subscript of a BVH
# node array (``models/attention.py``).
_R1_OK_ROTARY = """
def attend(L, layers, q, k, pos):
    for layer in layers:
        q, k = L.rope(q, pos), L.rope(k, pos)
    return q, k
"""

_R3_BAD = """
from repro_torch.core.query import query_csr_device
def consume(bvh, pred):
    res = query_csr_device(bvh, pred, 128)
    return res.indices
"""

_R3_OK_CHECKED = """
from repro_torch.core.query import query_csr_device
def consume(bvh, pred):
    res = query_csr_device(bvh, pred, 128)
    assert not bool(res.overflowed)
    return res.indices
"""

_R3_OK_RETURNED = """
from repro_torch.core.query import query_csr
def passthrough(bvh, pred):
    return query_csr(bvh, pred)
"""

_R3_OK_PRAGMA = """
from repro_torch.core.query import query_csr_device
def consume(bvh, pred):
    res = query_csr_device(bvh, pred, 128)  # staticcheck: overflow-ok
    return res.indices
"""

_R4_BAD = """
import torch
def fold(diff, L):
    return diff - torch.round(diff / L) * L
"""

_R4_BAD_METHOD = """
import torch
def fold(diff, L):
    return diff - (diff / L).round() * L
"""

_R4_OK_GUARDED = """
import torch
def fold(diff, L):
    k = torch.where(torch.abs(diff) > 2 * L, 0.0, torch.round(diff / L))
    return diff - k * L
"""

# The AdamW int8 quantizer (``optim/adamw.py``) rounds a quotient and
# never folds it back by the same scale.
_R4_OK_NOT_MINIMAGE = """
import torch
def quantize(g, scale):
    return torch.clamp(torch.round(g / scale), -127, 127)
"""

# (port fixture, the reference's fixture of the same case)
SEEDED = [
    ("R1-bvh-loop-outside-engine", _R1_BAD, "_R1_BAD"),
    ("R3-unchecked-csr-overflow", _R3_BAD, "_R3_BAD"),
    ("R4-unguarded-minimage-fold", _R4_BAD, "_R4_BAD"),
    ("R4-unguarded-minimage-fold", _R4_BAD_METHOD, "_R4_BAD"),
]
COMPLIANT = [
    (_R1_OK_UNION_FIND, "_R1_OK_UNION_FIND"),
    (_R1_OK_ROTARY, None),
    (_R3_OK_CHECKED, "_R3_OK_CHECKED"),
    (_R3_OK_RETURNED, "_R3_OK_RETURNED"),
    (_R3_OK_PRAGMA, "_R3_OK_PRAGMA"),
    (_R4_OK_GUARDED, "_R4_OK_GUARDED"),
    (_R4_OK_NOT_MINIMAGE, "_R4_OK_NOT_MINIMAGE"),
]


@pytest.mark.parametrize("rule,src,ref_name", SEEDED,
                         ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(SEEDED)])
def test_seeded_violation_fires_exactly_once(rule, src, ref_name):
    findings = lint_source(textwrap.dedent(src), "fixture.py")
    assert len(findings) == 1, findings
    assert findings[0].rule == rule
    assert findings[0].line > 0
    # The reference's verdict on its own fixture of the same case.
    want = ref.lint_source(textwrap.dedent(getattr(ref_fixtures, ref_name)),
                           "fixture.py")
    assert [f.rule for f in findings] == [f.rule for f in want]


@pytest.mark.parametrize("src,ref_name", COMPLIANT,
                         ids=[f"ok{i}" for i in range(len(COMPLIANT))])
def test_compliant_variant_is_silent(src, ref_name):
    assert lint_source(textwrap.dedent(src), "fixture.py") == []
    if ref_name is not None:
        assert ref.lint_source(textwrap.dedent(
            getattr(ref_fixtures, ref_name)), "fixture.py") == []


@pytest.mark.parametrize("name", ["_R2_BAD_DECORATOR", "_R2_BAD_CALL",
                                  "_R2_OK_GATED"])
def test_port_has_no_r2(name):
    """R2 guards a JAX construct (``jax.jit`` over ``shard_map``); the
    port has neither, so it has no R2 and the reference's R2 fixtures
    stay silent."""
    assert "R2" not in RULES
    src = textwrap.dedent(getattr(ref_fixtures, name))
    assert lint_source(src, "fixture.py") == []


@pytest.mark.parametrize("home", ["core/query.py", "core/traversal.py",
                                  "core/bvh.py", "kernels/wavefront.py",
                                  "kernels/nearest.py"])
def test_engine_files_exempt_from_r1(home):
    findings = lint_source(textwrap.dedent(_R1_BAD), f"src/repro_torch/{home}")
    assert findings == []


def test_r1_still_fires_in_unblessed_kernels_module():
    """The homes are named files, not the kernels package: a rogue rope
    loop in any OTHER kernels/ file keeps the one-fire contract."""
    findings = lint_source(textwrap.dedent(_R1_BAD),
                           "src/repro_torch/kernels/rogue.py")
    assert [f.rule for f in findings] == ["R1-bvh-loop-outside-engine"]


def test_r1_nested_loops_fire_once():
    src = textwrap.dedent(_R1_BAD).replace(
        "    while bool", "    for _ in range(2):\n      while bool")
    src = src.replace("\n        acc", "\n          acc").replace(
        "\n        node = bvh", "\n          node = bvh")
    findings = lint_source(src, "fixture.py")
    assert [(f.rule, f.line) for f in findings] == \
        [("R1-bvh-loop-outside-engine", 6)]


def test_generic_ignore_pragma():
    src = _R4_BAD.replace("torch.round(diff / L) * L",
                          "torch.round(diff / L) * L  # staticcheck: ignore")
    assert lint_source(textwrap.dedent(src), "fixture.py") == []


def test_clean_tree_has_zero_findings():
    findings, checked = lint_paths([SRC_PORT])
    assert checked > 50            # the walk really saw the package
    assert findings == [], [str(f) for f in findings]


# --- op rules, on the reference's toy functions ------------------------------

def _dense_jax(a):
    return ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)


def _dense_torch(a):
    return ((a[:, None, :] - a[None, :, :]) ** 2).sum(-1)


def test_no_dense_intermediate_fires_on_dense_staging():
    x, xj = torch.ones((64, 3)), jnp.ones((64, 3))
    findings = audit_ops(_dense_torch, (x,), [no_dense_intermediate(64 * 64)])
    want = ref.audit_jaxpr(_dense_jax, (xj,), [ref.no_dense_intermediate(64 * 64)])
    assert len(findings) == len(want) == 1
    assert findings[0].rule == want[0].rule == "no-dense-intermediate"
    # and the walker is really measuring: the reference's quantity
    assert max_intermediate_elems(_dense_torch, (x,)) == \
        ref.max_intermediate_elems(_dense_jax, (xj,)) >= 64 * 64


def test_no_dense_intermediate_silent_on_linear_fn():
    x, xj = torch.ones((64, 3)), jnp.ones((64, 3))
    findings = audit_ops(lambda a: (a * 2).sum(0), (x,),
                         [no_dense_intermediate(64 * 64), no_host_transfer()])
    want = ref.audit_jaxpr(lambda a: (a * 2).sum(0), (xj,),
                           [ref.no_dense_intermediate(64 * 64),
                            ref.no_host_transfer()])
    assert findings == want == []
    assert max_intermediate_elems(lambda a: (a * 2).sum(0), (x,)) == \
        ref.max_intermediate_elems(lambda a: (a * 2).sum(0), (xj,))


HOST_READS = {
    "item": (lambda a: a.sum() + a.max().item(), "_local_scalar_dense"),
    "bool": (lambda a: a * 2 if bool((a > 3).any()) else a, "_local_scalar_dense"),
    "nonzero": (lambda a: torch.nonzero(a > 3), "nonzero"),
    "mask_index": (lambda a: a[a > 3], "index"),
    "mask_assign": (lambda a: a.masked_fill(a > 3, 0).index_put_(
        (a > 5,), torch.zeros(())), "index_put_"),
    "unique": (lambda a: torch.unique(a), "_unique2"),
}


@pytest.mark.parametrize("case", sorted(HOST_READS))
def test_no_host_transfer_fires_on_host_reads(case):
    fn, op = HOST_READS[case]
    x = torch.arange(8.0)
    findings = audit_ops(fn, (x,), [no_host_transfer()])
    assert len(findings) == 1 and repr(op) in findings[0].message
    assert "ran 1 times" in findings[0].message
    # within an allowance of one read the call is clean
    assert audit_ops(fn, (x,), [no_host_transfer(allowed_syncs=1)]) == []


def test_no_host_transfer_counts_each_read():
    def loop(a):
        while bool((a > 0).any()):
            a = a - 1
        return a

    trace = trace_ops(loop, (torch.tensor([3.0, 1.0]),))
    assert trace.syncs() == {"_local_scalar_dense": 4}
    findings = no_host_transfer(allowed_syncs=lambda out: 3)(trace, "loop")
    assert len(findings) == 1 and "ran 4 times" in findings[0].message
    assert no_host_transfer(allowed_syncs=4)(trace, "loop") == []


def test_plain_kernel_version_is_not_a_host_sync():
    """On the CPU a kernel wrapper runs its plain version, which stands
    for the launch: its boolean indexes count for sizes, not as syncs."""
    from repro_torch.kernels.wavefront import wavefront_count

    rng = np.random.default_rng(1)
    pts = torch.from_numpy(rng.uniform(0, 1, (256, 3)).astype(np.float32))
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    bvh = build_bvh(pts, *scene_bounds(pts))
    r2 = torch.full((256,), 0.01, dtype=torch.float32)
    trace = trace_ops(lambda: wavefront_count(bvh, pts, r2))
    assert trace.n_syncs() == 0 and trace.n_ops > 100


def test_shard_threads_run_under_the_callers_trace():
    mesh = ShardMesh(4, "cpu")

    def body(axis, x):
        return bool(axis.psum(x.sum()) > 0)

    trace = trace_ops(lambda: mesh.run(body, torch.ones(8)))
    assert trace.syncs() == {"_local_scalar_dense": 4}


def test_assert_no_host_transfers_on_the_cpu():
    x = torch.arange(8.0)
    assert torch.equal(assert_no_host_transfers(lambda a: a * 2, x), x * 2)
    for guard in ("all", "d2h"):
        with pytest.raises(RuntimeError, match="_local_scalar_dense"):
            assert_no_host_transfers(lambda a: a * float(a.sum()), x,
                                     guard=guard)
    with pytest.raises(ValueError):
        assert_no_host_transfers(lambda a: a, x, guard="h2d")


def test_bounded_recompiles():
    fn = lambda q: (q ** 2).sum()  # noqa: E731
    unbucketed = [(torch.ones((n, 3)),) for n in range(1, 9)]
    bucketed = [(torch.ones((8, 3)),)] * 8
    ref_unbucketed = [(jnp.ones((n, 3)),) for n in range(1, 9)]
    ref_bucketed = [(jnp.ones((8, 3)),)] * 8
    assert count_compile_signatures(unbucketed) == \
        ref.count_compile_signatures(ref_unbucketed) == 8
    assert count_compile_signatures(bucketed) == \
        ref.count_compile_signatures(ref_bucketed) == 1
    assert len(bounded_recompiles(fn, unbucketed, 3)) == 1
    assert bounded_recompiles(fn, bucketed, 3) == []


# --- registered production audits (one test per entry point) -----------------

@pytest.mark.parametrize("audit", REGISTERED_AUDITS, ids=lambda a: a.name)
def test_registered_audit_is_clean(audit):
    assert audit.run(True, device="cpu") == []


def test_registered_names_are_the_references():
    from repro.staticcheck.registry import REGISTERED_AUDITS as REF_AUDITS
    assert [a.name for a in REGISTERED_AUDITS] == [a.name for a in REF_AUDITS]


def test_stats_path_identity_catches_a_leak(monkeypatch):
    """A counter op in the stats-off path breaks the identity."""
    from repro_torch.staticcheck import frozen_query

    real = frozen_query.frozen_count_stack
    monkeypatch.setattr(frozen_query, "frozen_count_stack",
                        lambda b, p: real(b, p) + torch.zeros(1, dtype=torch.int32))
    audit = next(a for a in REGISTERED_AUDITS
                 if a.name == "obs/stats_path_identity")
    findings = audit.run(True, device="cpu")
    assert [f.path for f in findings] == ["<ops:query_count[stack]>"]


def test_sync_allowances_bound_what_the_code_reads():
    """The allowances are counts of the loops' passes, and each is reached
    by no more than its own call makes at the fast size (checked by the
    audits above); here: they grow with the tree's height and the rounds a
    call returns."""
    assert registry.fdbscan_syncs(512, 20, 4) > registry.fdbscan_syncs(512, 20, 3)
    assert registry.fdbscan_syncs(512, 21, 3) > registry.fdbscan_syncs(512, 20, 3)
    assert registry.fdbscan_pair_syncs(512, 20, 4) > \
        registry.fdbscan_pair_syncs(512, 20, 3)
    assert registry.halo_pipeline_syncs(64, 64, [(9, 8)] * 4, [3] * 4, 2) < \
        registry.halo_pipeline_syncs(64, 64, [(9, 8)] * 4, [3, 3, 3, 4], 2)


@pytest.mark.parametrize("n,clustered", [(2, False), (128, False),
                                         (1000, False), (1000, True)])
def test_build_allowance_is_the_builds_loop_count(n, clustered):
    """``build_bvh``'s allowance is its loops' exact pass count: the three
    searches as the root's range decides them, and the box fixpoint's
    passes the tree's height. On the CPU a pass of the fixpoint makes four
    boolean indexes; the fifth sync the allowance counts, a Python ``True``
    assigned through an index, is a copy only on the card."""
    from repro_torch.core.bvh import build_bvh
    from repro_torch.core.geometry import scene_bounds
    from repro_torch.data.pipeline import make_clustered_points

    rng = np.random.default_rng(n)
    pts = (make_clustered_points(rng, n) if clustered
           else rng.uniform(0, 1, (n, 3)).astype(np.float32))
    p = torch.from_numpy(pts)
    trace = trace_ops(lambda: build_bvh(p, *scene_bounds(p)))
    height = registry.tree_height(trace.result)
    assert height == registry.height_of(p)
    by_line = {}
    for (_, where), k in trace.syncs_by_line().items():
        assert where.startswith("src/repro_torch/core/bvh.py:"), where
        line = int(where.rsplit(":", 1)[1])
        by_line[line] = by_line.get(line, 0) + k
    searches = sum(k for line, k in by_line.items() if line < 150)
    box = sum(k for line, k in by_line.items() if line >= 150)
    assert searches == registry.search_syncs(n)
    assert box == 4 * height
    assert registry.build_bvh_syncs(n, height) == searches + 5 * height


# --- CLI contract: the seeded violation through ``python -m``, the rest
# through the same ``main`` in this process ----------------------------------

def _run_cli(args, cwd):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.staticcheck",
                           *args], capture_output=True, text=True, env=env,
                          cwd=cwd)


def test_cli_clean_tree_exits_zero(tmp_path, capsys):
    report = tmp_path / "report.json"
    assert cli.main([SRC_PORT, "--json", str(report)]) == 0, \
        capsys.readouterr().out
    data = json.loads(report.read_text())
    assert data["ok"] and data["findings"] == [] and data["op_audits"] == []
    assert data["checked_files"] > 50


def test_cli_seeded_violation_exits_nonzero_with_location(tmp_path):
    bad = tmp_path / "violation.py"
    bad.write_text(textwrap.dedent(_R4_BAD))
    report = tmp_path / "report.json"
    out = _run_cli([str(bad), "--json", str(report)], cwd=str(tmp_path))
    assert out.returncode == 1
    data = json.loads(report.read_text())
    assert not data["ok"] and len(data["findings"]) == 1
    f = data["findings"][0]
    assert f["path"] == str(bad) and f["line"] == 4
    assert f"{bad}:4" in out.stdout   # file:line in the human output too


def test_cli_rejects_unknown_rules(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli.main(["--rules", "R2", "--json", str(tmp_path / "r.json")])
    assert exc.value.code == 2 and "unknown rules" in capsys.readouterr().err
