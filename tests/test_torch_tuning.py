"""The autotuner of the port (``repro_torch.core.tuning``) against the
reference's (``repro.core.tuning``), on the CPU.

The same decisions go through both packages: the mode resolution, the
overlap-save block space and its pick (the reference's ``backend="xla"``),
and the plan space of the card, whose ``"model"`` pick at the reference's
budget builds the reference's ``backend="pallas"`` program pass for pass.
The measurement discipline (a cache hit measures nothing, a fresh cache
object reads the file, corrupt files are quarantined) runs with a
deterministic fake measure function.  Every test keeps the cache in a
throwaway file.
"""

import dataclasses
import json
import os
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fft as ref_fft
from repro.core import limits as ref_limits
from repro.core import overlap as ref_ov
from repro.core import tuning as ref_tuning
from repro_torch.core import fft as F
from repro_torch.core import overlap as O
from repro_torch.core import plan as plan_lib
from repro_torch.core import tuning
from repro_torch.kernels import ops, pencil

TOL = 1e-3


@pytest.fixture
def fresh_cache(tmp_path, monkeypatch):
    """An empty persistent cache in a throwaway file, a clean measure log
    and no mode in the environment."""
    path = str(tmp_path / "tuning.json")
    monkeypatch.setenv("REPRO_TUNING_CACHE", path)
    monkeypatch.delenv("REPRO_FFT_TUNE", raising=False)
    tuning.cache.clear()
    tuning.clear_measure_log()
    yield path
    tuning.cache.clear()
    tuning.clear_measure_log()


def _real(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _rel(got, ref):
    got, ref = np.asarray(got, np.complex128), np.asarray(ref, np.complex128)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1e-30)


# ---------------------------------------------------------------------------
# mode resolution and keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("env", [None, "off", "model", "measure"])
def test_resolve_mode_follows_the_environment(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("REPRO_FFT_TUNE", raising=False)
    else:
        monkeypatch.setenv("REPRO_FFT_TUNE", env)
    assert tuning.resolve_mode(None) == ref_tuning.resolve_mode(None) == (env or "model")
    assert tuning.resolve_mode("off") == "off"
    with pytest.raises(ValueError, match="tune must be"):
        tuning.resolve_mode("fastest")


def test_cache_path_and_device_key(monkeypatch):
    monkeypatch.delenv("REPRO_TUNING_CACHE", raising=False)
    assert tuning.cache_path().endswith(os.path.join(".cache", "repro-torch-fft", "tuning.json"))
    monkeypatch.setenv("REPRO_TUNING_CACHE", "/elsewhere/t.json")
    assert tuning.cache_path() == "/elsewhere/t.json"
    assert tuning.device_key("cpu") == "cpu"


def test_seed_is_package_data_keyed_for_the_port():
    seed = tuning.seed_cache()
    assert isinstance(seed, dict)
    for key, entry in seed.items():
        assert key.startswith("torch|") and "|cpu|" not in key, key
        assert entry["mode"] == "measure" and isinstance(entry["config"], dict)


# ---------------------------------------------------------------------------
# the overlap-save block
# ---------------------------------------------------------------------------

OS_SHAPES = [(1 << 20, 4097, 32, None), (1 << 16, 129, 1, None), (40000, 33, 4, None),
             (16384, 1025, 1, 65536), (2048, 2, 3, 64), (1 << 16, 32769, 1, None)]


@pytest.mark.parametrize("L,Lh,batch,chunk", OS_SHAPES)
def test_os_block_space_equals_the_reference(L, Lh, batch, chunk):
    got = tuning.TuningSpace.for_os_block(L, Lh, batch, "cpu", chunk=chunk)
    want = ref_tuning.TuningSpace.for_os_block(L, Lh, batch, "xla", chunk=chunk)
    assert [c[:2] for c in got.candidates] == [c[:2] for c in want.candidates]
    assert got.candidates[0][0]["block"] == O.pick_block(Lh)


@pytest.mark.parametrize("L,Lh,batch,chunk", OS_SHAPES)
@pytest.mark.parametrize("mode", ["off", "model"])
def test_tuned_block_equals_the_reference(L, Lh, batch, chunk, mode, fresh_cache):
    got = tuning.tuned_block(L, Lh, batch, "cpu", mode, chunk=chunk)
    assert got == ref_tuning.tuned_block(L, Lh, batch, "xla", mode, chunk=chunk)
    assert got == tuning.modeled_block(L, Lh, batch, "cpu", chunk=chunk) or mode == "off"
    assert tuning.measure_log() == ()


def test_fft_conv_os_measure_on_the_cpu(fresh_cache):
    x, h = _real((2, 40000)), _real((129,), seed=1)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    y = O.fft_conv_os(xt, ht, tune="measure")
    assert tuning.measure_log(), "the first call measures"
    assert {d for d, *_ in tuning.measure_log()} == {"os_block"}
    off = O.fft_conv_os(xt, ht, tune="off")
    ref = np.asarray(ref_ov.fft_conv_os(jnp.asarray(x), jnp.asarray(h), backend="xla", tune="off"))
    assert _rel(y, off) <= TOL and _rel(y, ref) <= TOL
    n = len(tuning.measure_log())
    O.fft_conv_os(xt, ht, tune="measure")
    assert len(tuning.measure_log()) == n, "the second call measures nothing"


# ---------------------------------------------------------------------------
# the plan space of the card
# ---------------------------------------------------------------------------

PLAN_SPECS = [
    (4096, None, "fft"),
    (1 << 17, None, "fft"),
    (1 << 20, None, "ifft"),
    (3000, None, "fft"),
    (64, 1 << 17, "fft2"),
    (1 << 17, 64, "ifft2"),
]


def _build(spec, cfg):
    if spec.n2 is not None:
        return plan_lib.plan_fft2(spec.n, spec.n2, cfg["fused_max"], cfg["direct_max"])
    return plan_lib.plan_fft(spec.n, cfg["fused_max"], cfg["direct_max"], pad=cfg.get("bluestein_pad"))


@pytest.mark.parametrize("n,n2,kind", PLAN_SPECS)
def test_model_plan_is_the_reference_pallas_program(n, n2, kind, fresh_cache):
    budget = ref_limits.memory_budget()  # the reference's, on this host
    spec = F.FFTSpec(n, kind=kind, n2=n2)
    cfg = tuning.plan_config(spec, "cuda", "model", device="cpu", budget=budget)
    ref = ref_fft.plan(ref_fft.FFTSpec(n=n, kind=kind, n2=n2), backend="pallas", tune="model")
    # pass_record reads a pass's fields by name, so it reads the
    # reference's passes as well.
    got = [plan_lib.pass_record(p) for p in _build(spec, cfg).passes]
    assert got == [plan_lib.pass_record(p) for p in ref.fft_plan.passes]
    for key in ("fused_max", "direct_max", "bluestein_pad"):
        assert cfg.get(key) == ref.tuned.get(key), key
    # "model" keeps the table's forms: they tie in modelled bytes.
    takes = ops.form_passes(_build(spec, cfg), -1)
    assert cfg["forms"] == {str(i): pencil.table_form(k, f) for i, (k, f) in takes.items()}
    assert tuning.measure_log() == ()


@pytest.mark.parametrize("n,n2,kind", PLAN_SPECS)
def test_every_form_candidate_fits(n, n2, kind):
    budget = 227 * 1024  # one H100 block's shared memory
    spec = F.FFTSpec(n, kind=kind, n2=n2)
    space = tuning.TuningSpace.for_plan(spec, "cpu", budget)
    assert space.candidates[0][0]["fused_max"] == plan_lib.FUSED_MAX
    assert space.candidates[0][0]["direct_max"] == plan_lib.DIRECT_MAX
    seen = set()
    for cfg, nbytes, work in space.candidates:
        program = _build(spec, cfg)
        forms = {int(k): v for k, v in cfg["forms"].items()}
        ops.check_forms(program, forms, -1, budget)  # raises if one does not fit
        assert work == max((pencil.form_smem_bytes(v) for v in forms.values()), default=0) <= budget
        assert nbytes == plan_lib.program_hbm_bytes(program.passes, 1, (n2, n) if n2 else None)
        seen.add(json.dumps(cfg, sort_keys=True))
    assert len(seen) == len(space.candidates)


@pytest.mark.parametrize("n", [1 << 29, 1 << 30])
def test_three_factor_candidates_are_the_reference_ones(n):
    """Past 2^28 the reference's fused_max alternatives give programs of
    three factors and a reorder; the port's candidate programs (fused_max,
    direct_max, the pass list) are the same set.  Planning only: no LUT."""
    spec = F.FFTSpec(n)
    space = tuning.TuningSpace.for_plan(spec, "cpu", 227 * 1024)
    ref_space = ref_tuning.TuningSpace.for_plan(ref_fft.FFTSpec(n), "pallas")

    def programs(candidates):
        out = set()
        for cfg, *_ in candidates:
            passes = _build(spec, {"direct_max": plan_lib.DIRECT_MAX, **cfg}).passes
            out.add((cfg["fused_max"], cfg.get("direct_max", plan_lib.DIRECT_MAX),
                     json.dumps([plan_lib.pass_record(p) for p in passes])))
        return out

    got = programs(space.candidates)
    assert got == programs(ref_space.candidates)
    by_fm = {fm: json.loads(rec) for fm, _dm, rec in got}
    assert set(by_fm) == {plan_lib.FUSED_MAX, plan_lib.FUSED_MAX // 4}
    assert [p["kind"] for p in by_fm[plan_lib.FUSED_MAX // 4]][-1] == "reorder"
    assert len(by_fm[plan_lib.FUSED_MAX // 4]) == 4


def test_forms_refused_at_plan_time():
    program = plan_lib.plan_fft(1 << 20)  # cols_pass and rows_natural at f = 1024
    ops.check_forms(program, {0: 12, 1: pencil.SLAB})
    with pytest.raises(F.PlanError, match="takes no form"):
        ops.check_forms(plan_lib.plan_fft(4096), {0: 13})
    with pytest.raises(F.PlanError, match="does not fit"):
        ops.check_forms(plan_lib.plan_fft(1 << 30), {0: 14})  # f = 32768 > 2^14
    with pytest.raises(F.PlanError, match="shared memory"):
        ops.check_forms(program, {0: 14}, budget=64 * 1024)


def test_small_four_step_leaves_are_no_candidates():
    # The reference's direct_max alternatives reach a whole-signal four-step
    # of 512 points, whose 16-point factor fft4step does not take.
    space = tuning.TuningSpace.for_plan(F.FFTSpec(512), "cpu", 227 * 1024)
    assert [c[0]["direct_max"] for c in space.candidates] == [plan_lib.DIRECT_MAX]
    space = tuning.TuningSpace.for_plan(F.FFTSpec(1024), "cpu", 227 * 1024)
    assert {c[0]["direct_max"] for c in space.candidates} == {1024, 512, 256}


@pytest.mark.parametrize("n,n2,kind", [(1024, None, "fft"), (1 << 17, None, "ifft"),
                                       (3000, None, "fft"), (64, 1 << 12, "fft2")])
def test_tuned_program_runs_and_describes_itself(n, n2, kind, fresh_cache):
    # A "model" config of the card, executed here through the plain
    # versions: the tuned program computes the transform.
    spec = F.FFTSpec(n, kind=kind, n2=n2)
    cfg = tuning.plan_config(spec, "cuda", "model", device="cpu", budget=227 * 1024)
    program = _build(spec, cfg)
    cpu = torch.device("cpu")
    inverse = kind.startswith("i")
    planned = F.PlannedFFT(spec, F._backend_for(cpu), program, cpu,
                           ops.plan_luts(program, inverse, cpu), tuned=cfg)
    text = planned.describe()
    assert "tuned:" in text and "direct_max=" in text
    shape = (2, n2, n) if n2 else (3, n)
    x = _real(shape) + 1j * _real(shape, seed=1)
    y = planned(torch.from_numpy(x.astype(np.complex64))).numpy()
    axes = (-2, -1) if n2 else (-1,)
    ref = np.fft.ifftn(x, axes=axes) if inverse else np.fft.fftn(x, axes=axes)
    assert _rel(y, ref) <= TOL


def test_bluestein_tax_is_the_reference_one():
    text = F.plan(F.FFTSpec(3000), device="cpu").describe()
    ref = ref_fft.plan(ref_fft.FFTSpec(n=3000), backend="xla", tune="off").describe()
    tax = ref[ref.index("; bluestein: ") + len("; bluestein: "):]
    assert "bluestein: n=3000 " + tax.split(";")[0] in text


# ---------------------------------------------------------------------------
# decide(): the measurement discipline
# ---------------------------------------------------------------------------


def _space(times, nbytes=None, key="fake|plan|n=1"):
    """A space of len(times) candidates whose fake measurement returns
    ``times[config["i"]]`` and counts its calls."""
    calls = []
    nbytes = nbytes or [100] * len(times)

    def measure(cfg):
        calls.append(cfg["i"])
        return times[cfg["i"]]

    cands = [({"i": i}, nbytes[i], 0) for i in range(len(times))]
    return tuning.TuningSpace("fake", key, cands, measure, device="cpu"), calls


def test_decide_picks_the_fastest(fresh_cache):
    space, calls = _space([1.0, 0.5, 0.8])
    assert space.decide("measure") == {"i": 1}
    assert sorted(calls) == [0, 0, 1, 1, 2, 2]  # every survivor, every round
    assert len(tuning.measure_log()) == 6


def test_decide_keeps_the_heuristic_within_the_margin(fresh_cache):
    space, _ = _space([1.0, 0.95])
    assert space.decide("measure") == {"i": 0}
    assert space.decide("off") == {"i": 0}


def test_decide_cache_hit_measures_nothing(fresh_cache):
    space, calls = _space([1.0, 0.5])
    space.decide("measure")
    n = len(calls)
    again, calls2 = _space([1.0, 0.5])
    assert again.decide("measure") == {"i": 1} and calls2 == []
    assert len(calls) == n
    # A fresh cache object reads the winner from the file.
    fresh = tuning.TuningCache()
    assert fresh.get(f"torch|cpu|{space.key}") == {"config": {"i": 1}, "mode": "measure"}
    with open(fresh_cache) as f:
        doc = json.load(f)
    assert doc["version"] == tuning.CACHE_SCHEMA_VERSION


def test_model_entry_is_upgraded_by_measure(fresh_cache):
    space, calls = _space([1.0, 0.5], nbytes=[100, 200])
    assert space.decide("model") == {"i": 0} and calls == []  # 200 > 100·1.2: pruned
    assert space.decide("model") == {"i": 0} and calls == []  # cached
    # The model pruned candidate 1, but measure times the survivors (the
    # heuristic only), so the pick stays; the entry becomes "measure".
    assert space.decide("measure") == {"i": 0} and calls == [0, 0]
    assert tuning.cache.get(f"torch|cpu|{space.key}")["mode"] == "measure"
    assert space.decide("measure") == {"i": 0} and calls == [0, 0]


@pytest.mark.parametrize("content", ["{not json", json.dumps({"version": 99, "entries": {}})],
                         ids=["corrupt", "foreign"])
def test_unusable_cache_file_is_quarantined(content, fresh_cache):
    with open(fresh_cache, "w") as f:
        f.write(content)
    with pytest.warns(RuntimeWarning, match="quarantined"):
        assert tuning.TuningCache().get("torch|cpu|anything") is None
    assert os.path.exists(fresh_cache + ".corrupt") and not os.path.exists(fresh_cache)


def test_the_reference_reads_a_file_the_port_wrote(fresh_cache):
    # Both packages honour REPRO_TUNING_CACHE; a port entry must not get the
    # shared file quarantined by the reference, and writes merge.
    space, _ = _space([1.0, 0.5])
    space.decide("measure")
    ref_tuning.TuningCache().put("cpu|xla|os_block|L=1,Lh=1,batch=1",
                                 {"config": {"block": 8}, "mode": "model"})
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        entries = ref_tuning.TuningCache()._read_file(fresh_cache)
        mine = tuning.TuningCache()._read_file(fresh_cache)
    assert entries == mine and f"torch|cpu|{space.key}" in entries and len(entries) == 2


# ---------------------------------------------------------------------------
# the spectral layer's stream plan
# ---------------------------------------------------------------------------


def test_stream_plan_info_equals_the_reference():
    from repro.configs import base as ref_base
    from repro.configs.reduce import make_reduced as ref_make_reduced
    from repro.models.layers.spectral import stream_plan_info as ref_info
    from repro_torch.configs import base
    from repro_torch.configs.reduce import make_reduced
    from repro_torch.models.layers.spectral import stream_plan_info

    ref = ref_make_reduced(dataclasses.replace(ref_base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
    port = make_reduced(dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True))
    for batch in (1, 4):
        assert stream_plan_info(port, batch) == ref_info(ref, batch)
    full = dataclasses.replace(base.get_config("h2o-danube-1.8b"), use_spectral_mixer=True)
    assert stream_plan_info(full)["block"] == 2048
