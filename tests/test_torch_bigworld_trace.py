"""Port traversal of worlds above 1024^3 (svo_raytracer_torch
intersect_wavefront on the CPU, through trace_plain) vs the JAX package's
intersect_wavefront (Pallas kernel in interpret mode) and its XLA oracle
brick_trace.intersect_bricks, on the G = 64 (2048^3) and paged 4096^3
scenes of chip_smoke.py.

Thresholds are the JAX package's own tests':
  * G = 64, tests/test_wavefront.py test_g64_world against the oracle
    (hit agreement >= 0.99, value and t within 2e-4 on >= 98% of shared
    hits);
  * paged, tests/test_paged.py test_paged_matches_oracle (hit equal, t
    within 2e-4, value equal, voxel_pos within 2e-3 on every shared hit);
  * both, the _compare floors against JAX intersect_wavefront (hit
    agreement >= 0.995, strict fields >= 0.98).
JAX runs a ray that finds its page missing from the tile's KPAGE = 4
candidates again from a nudged point, so on paged worlds its t and iters
may differ from the never-punted answer; the rays equal to JAX in every
field are counted and printed.  On 'aimed' rays (most of them hit) only
the oracle runs: it is fast, JAX's interpret mode is not.  attr16 and 2-D
attribute storage must give the int32 flat answer ray for ray
(tests/test_paged.py test_paged_attr16_matches_int32 and
test_paged_attr2d_matches_flat)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from svo_raytracer_tpu.ops import brick_trace as jbrick_trace
from svo_raytracer_tpu.ops import wavefront as jwavefront
from svo_raytracer_torch.ops import wavefront
from test_torch_bigworld import SCENES, _jax_scene
from test_traverse_batch import random_rays


def _paged_rays(n, seed):
    """tests/test_paged.py _rand_rays: origins inside the world cube,
    directions uniform on the sphere (world units)."""
    rs = np.random.RandomState(seed)
    o = (rs.rand(n, 3) * 0.9 + 1.05).astype(np.float32)
    d = rs.randn(n, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _rays(name, kind, scene):
    if kind == "aimed":
        return chip_smoke.aimed_rays(scene, 1024, seed=3)
    if name == "g64":
        return random_rays(256, seed=17)          # test_g64_world's rays
    return _paged_rays(2048, seed=5)              # test_paged_matches_oracle


def _np(res):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in res._asdict().items()}


@pytest.fixture(scope="module")
def traced():
    """Per (scene, ray kind): (port, oracle, JAX wavefront or None) results
    as NumPy dicts, plus the port's scene and rays."""
    out = {}
    for name, make in SCENES.items():
        scene = make()
        jscene = _jax_scene(scene)
        ws = wavefront.prepare(scene, "cpu")
        jws = jwavefront.prepare(jscene)
        for kind in ("random", "aimed"):
            o, d = _rays(name, kind, scene)
            got = wavefront.intersect_wavefront(ws, torch.from_numpy(o),
                                                torch.from_numpy(d))
            oracle = jbrick_trace.intersect_bricks(
                jscene.to_device(), jnp.asarray(o), jnp.asarray(d))
            wf = (jwavefront.intersect_wavefront(
                jws, jnp.asarray(o), jnp.asarray(d), interpret=True)
                  if kind == "random" else None)
            out[name, kind] = (_np(got), _np(oracle),
                               None if wf is None else _np(wf), scene, o, d)
    return out


CASES = [(n, k) for n in SCENES for k in ("random", "aimed")]


@pytest.mark.parametrize("case", CASES)
def test_matches_oracle(traced, case):
    got, ref, _, _, _, _ = traced[case]
    rh, gh = ref["hit"], got["hit"]
    both = rh & gh
    dt = np.abs(ref["t"] - got["t"])[both]
    val = ref["value"][both] == got["value"][both]
    print(f"{case}: {both.sum()} shared hits of {rh.size} rays, hit "
          f"agreement {(rh == gh).mean():.4f}")
    assert both.sum() >= (1 if case == ("g64", "random") else 10)
    if case[0] == "g64":
        assert (rh == gh).mean() >= 0.99
        assert val.mean() >= 0.98 and (dt <= 2e-4).mean() >= 0.98
    else:
        assert (rh == gh).all() and val.all() and (dt <= 2e-4).all()
        rv, gv = ref["voxel_pos"][both], got["voxel_pos"][both]
        ok = np.isfinite(rv) & np.isfinite(gv)
        assert np.allclose(rv[ok], gv[ok], atol=2e-3)
    if case[1] == "aimed":
        assert both.mean() > 0.5          # the aimed rays really hit


@pytest.mark.parametrize("name", list(SCENES))
def test_matches_wavefront(traced, name):
    got, _, ref, _, _, _ = traced[name, "random"]
    agree = (ref["hit"] == got["hit"]).mean()
    both = ref["hit"] & got["hit"]
    strict = np.ones(both.shape, bool)
    strict &= ~both | (ref["value"] == got["value"])
    strict &= ~both | (ref["depth"] == got["depth"])
    strict &= ~both | (np.abs(ref["t"] - got["t"]) <= 2e-4)
    diff = np.abs(ref["normal"] - got["normal"]).max(-1)
    strict &= ~both | (diff <= 1e-5) | np.isnan(diff)   # raw 555: NaN both
    exact = np.ones(both.shape, bool)
    for k in ("hit", "t", "iters", "node", "value"):
        exact &= ref[k] == got[k]
    print(f"{name}: hit agreement {agree:.4f}, strict "
          f"{strict[both].mean():.4f}, equal in hit/t/iters/node/value on "
          f"{exact.sum()} of {exact.size} rays, max |dt| "
          f"{np.abs(ref['t'] - got['t']).max()}")
    assert both.any()
    assert agree >= 0.995
    assert strict[both].mean() >= 0.98


@pytest.mark.parametrize("kind", ["random", "aimed"])
@pytest.mark.parametrize("name", list(SCENES))
def test_attr_storage_matches_int32(traced, name, kind):
    got, _, _, scene, o, d = traced[name, kind]
    hit = got["hit"]
    for attr16, attr2d in ((True, None), (False, True), (True, True)):
        ws = wavefront.prepare(scene, "cpu", attr16=attr16, attr2d=attr2d)
        res = _np(wavefront.intersect_wavefront(ws, torch.from_numpy(o),
                                                torch.from_numpy(d)))
        assert np.array_equal(res["hit"], hit)
        for k in ("value", "depth", "t", "iters"):
            assert np.array_equal(res[k][hit], got[k][hit]), (attr16, k)
        fin = np.isfinite(res["normal"]) & np.isfinite(got["normal"])
        assert np.array_equal(np.isfinite(res["normal"]),
                              np.isfinite(got["normal"]))
        assert np.allclose(res["normal"][fin], got["normal"][fin])
        if not attr2d:
            assert np.array_equal(res["node"], got["node"])
