"""Shared inputs of the source_tpu_torch parity tests (no tests in here):
the test configuration, the JAX-side "zoo" scene, the carriers that hand a
compiled scene across between the two packages as numpy arrays, the
compile of a JAX reference with LLVM's optimisation off, and the training
step of both packages on the same streams."""

import contextlib
import os

import numpy as np
import torch

import jax
import jax.numpy as jnp

import source_tpu as S
from source_tpu.optical import InterpolatedSF
from source_tpu.optical.material import (
    AbsorbingSurface, AnisotropicSurfaceEmitter, Checkerboard, Conductor,
    Lambert, NullSurface, PerfectReflectingSurface, RoughConductor,
    UniformSurfaceEmitter, UniformVolumeEmitter,
)
from source_tpu.compiler.scene import CompiledScene as JaxCompiledScene
from source_tpu.primitive import Box, Cone, Cylinder, Parabola, Sphere, Torus
from source_tpu.tracer.meshtrace import MeshTables as JaxMeshTables

from source_tpu_torch.bridge import (
    ARRAY_FIELDS, MESH_ARRAYS, MESH_STATIC, STATIC_FIELDS, scene_from_numpy,
)

B = 5  # spectral bins of every parity test
CFG = dict(max_depth=6, extinction_prob=0.1, extinction_min_depth=3,
           importance_sampling=True, important_path_weight=0.25, max_iters=8)


def jax_zoo():
    """The zoo scene of tests/test_fused.py, compiled by the JAX package:
    every built-in material the Cornell box lacks, all six solids."""
    w = S.World()
    ns = InterpolatedSF([400, 700], [1.2, 1.1])
    ks = InterpolatedSF([400, 700], [5.0, 4.0])
    spec = InterpolatedSF([400, 700], [1.0, 3.0])
    mats = [
        Conductor(ns, ks),
        RoughConductor(ns, ks, 0.3),
        AnisotropicSurfaceEmitter(spec, 1.0, 2.0),
        Checkerboard(0.3, spec, InterpolatedSF([400, 700], [3.0, 1.0]), 1.0),
        PerfectReflectingSurface(),
        NullSurface(),
        AbsorbingSurface(),
        UniformVolumeEmitter(spec, 0.7),
        Lambert(InterpolatedSF([400, 700], [0.4, 0.6])),
    ]
    rng = np.random.RandomState(5)
    for i, mat in enumerate(mats):
        x, y, z = rng.uniform(-2.0, 2.0, 3)
        t = S.translate(x, y, z) * S.rotate_x(float(rng.uniform(0, 90)))
        kind = i % 5
        if kind == 0:
            Sphere(0.5, parent=w, transform=t, material=mat)
        elif kind == 1:
            Box(S.Point3D(-0.4, -0.3, -0.2), S.Point3D(0.4, 0.3, 0.2),
                parent=w, transform=t, material=mat)
        elif kind == 2:
            Cylinder(0.35, 0.7, parent=w, transform=t, material=mat)
        elif kind == 3:
            Cone(0.35, 0.6, parent=w, transform=t, material=mat)
        else:
            Parabola(0.35, 0.5, parent=w, transform=t, material=mat)
    Torus(0.8, 0.25, parent=w,
          transform=S.translate(0.0, -1.2, 1.0) * S.rotate_x(30.0),
          material=Lambert(InterpolatedSF([400, 700], [0.5, 0.5])))
    Box(S.Point3D(-3, -3, 4.0), S.Point3D(3, 3, 4.1), parent=w,
        material=UniformSurfaceEmitter(spec, 2.0))
    return S.compile_scene(w, S.SpectralConfig(375.0, 740.0, B))


def carry_scene(js, device="cpu", materials=None):
    """A JAX CompiledScene as the port's, through ``scene_from_numpy``;
    ``materials`` hands the port's objects of the user BSDF and
    inhomogeneous volume rows."""
    arrays = {k: np.asarray(getattr(js, k)) for k in ARRAY_FIELDS}
    if js.leaf_bvh is not None:
        arrays["leaf_bvh"] = {k: np.asarray(v) for k, v in js.leaf_bvh.items()}
    arrays["meshes"] = [
        {**{k: np.asarray(getattr(m, k)) for k in MESH_ARRAYS},
         **{k: getattr(m, k) for k in MESH_STATIC}} for m in js.meshes]
    static = {k: getattr(js, k) for k in STATIC_FIELDS}
    static["volume_entities"] = tuple(
        r[:3] + (None,) + r[4:] for r in js.volume_entities)
    return scene_from_numpy(arrays, static, device=device, materials=materials)


def to_jax(ts):
    """The port's compiled scene as the JAX package's, so both trace the same
    tables, meshes included (without the TPU packing of a mesh, which the
    JAX package's CPU route does not read). Spectral baking is held to the
    reference in tests/test_torch_compile.py; the JAX compile of a
    dispersive glass costs seconds of eager resampling."""
    arrays = {k: jnp.asarray(getattr(ts, k).numpy()) for k in ARRAY_FIELDS}
    static = {k: getattr(ts, k) for k in STATIC_FIELDS}
    bvh = (None if ts.leaf_bvh is None else
           {k: jnp.asarray(v.numpy()) for k, v in ts.leaf_bvh.items()})
    meshes = tuple(JaxMeshTables(
        **{k: jnp.asarray(getattr(m, k).numpy()) for k in MESH_ARRAYS},
        **{k: getattr(m, k) for k in MESH_STATIC}) for m in ts.meshes)
    return JaxCompiledScene(**arrays, **static, leaf_bvh=bvh, meshes=meshes)


@contextlib.contextmanager
def env(**kw):
    """Environment variables set for the duration of a with-block."""
    prev = {k: os.environ.get(k) for k in kw}
    os.environ.update(kw)
    try:
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def jax_compiled(fn, *args):
    """``fn`` compiled by XLA for the CPU with LLVM's optimisation off (at
    the default level the CPU build of the reference's ``trace_step``
    returns a zero normal on some CSG lanes, ROADMAP.md queue 3)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})


def uniform_streams(key, n_uniforms=10):
    """The reference's bounce uniforms ``uniform(fold_in(key, 0x7A000 +
    start), (n_steps, N, n_uniforms))`` and compaction rotations
    ``randint(fold_in(key, 1_000_000 + done), (), 0, alive)`` as the port's
    ``u_all`` and ``shifts``."""
    def u_all(start, n_steps, n_lanes):
        u = jax.random.uniform(jax.random.fold_in(key, 0x7A000 + start),
                               (n_steps, n_lanes, n_uniforms), jnp.float32)
        return torch.from_numpy(np.array(u))

    def shifts(done, alive_count):
        return int(jax.random.randint(jax.random.fold_in(key, 1_000_000 + done),
                                      (), 0, max(alive_count, 1)))
    return u_all, shifts


def masked_grad_pair(ts, js, cfg, o, d, key, bins, **port_kw):
    """The training step of both packages on the same scene, rays and
    streams, against target 0 except on the lanes whose forward radiance
    differs between them (rtol 1e-4, atol 1e-6): their target is the side's
    own radiance, so they add nothing to either loss or gradient.

    The reference is ``jax.value_and_grad`` of its ``render_batch(
    differentiable=True)`` loss over the scene pytree, SOURCE_TPU_FUSED=0,
    SOURCE_TPU_LEAF_BVH=0, compiled by ``jax_compiled`` with its
    ``remat_block=0`` (at LLVM level 0 its checkpointed scan returns NaN,
    ROADMAP.md queue 3). ``cfg`` is the RayConfig keywords; ``port_kw`` goes
    to the port's ``render_loss_and_grads`` beside ``u_all``/``shifts``.
    Returns dict(masked, ref=(loss, grads pytree), got=(loss, grads),
    u_all, shifts)."""
    import source_tpu_torch as T
    from source_tpu.parallel.engine import render_batch as jax_render_batch
    from source_tpu.tracer.wavefront import RayConfig as JaxRayConfig
    from source_tpu_torch.tracer.wavefront import _n_uniforms

    u_all, shifts = uniform_streams(key, _n_uniforms(ts))
    jcfg = JaxRayConfig(**cfg, remat_block=0)
    oj, dj = jnp.asarray(o), jnp.asarray(d)

    def step(scene, target):
        def loss_fn(scene, target):
            fin = jax_render_batch(scene, jcfg, oj, dj, key,
                                   differentiable=True)
            return jnp.mean((fin.radiance - target) ** 2), fin.radiance
        return jax.value_and_grad(loss_fn, has_aux=True, allow_int=True)(
            scene, target)

    zero = jnp.zeros((len(o), bins), jnp.float32)
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        ref_step = jax_compiled(step, js, zero)
    (_, rad_j), _ = ref_step(js, zero)
    rad_j = np.asarray(rad_j)
    rad_p = T.render_batch(ts, T.RayConfig(**cfg), o, d, u_all=u_all,
                           shifts=shifts, differentiable=True, device="cpu"
                           ).radiance.detach().numpy()
    agree = np.isclose(rad_p, rad_j, rtol=1e-4, atol=1e-6).all(-1)
    (loss_j, _), g_j = ref_step(
        js, jnp.asarray(np.where(agree[:, None], 0.0, rad_j), jnp.float32))
    got = T.render_loss_and_grads(
        ts, T.RayConfig(**cfg), o, d,
        np.where(agree[:, None], 0.0, rad_p).astype(np.float32),
        u_all=u_all, shifts=shifts, device="cpu", **port_kw)
    return dict(masked=int((~agree).sum()), ref=(float(loss_j), g_j), got=got,
                u_all=u_all, shifts=shifts)


def trace_step_parity(js, ts, cfg, o, d, u_all, bins=B, max_flip=0.005):
    """``trace_step`` of both packages bounce by bounce, each bounce from the
    reference's state, on the same uniforms ``u_all`` [n, N, n_uniforms]
    (the reference compiled once by ``jax_compiled``, SOURCE_TPU_FUSED=0,
    SOURCE_TPU_LEAF_BVH=0): continuous state within rtol 1e-5 / atol 1e-6
    on the lanes whose alive and depth agree, at most ``max_flip`` of the
    lanes otherwise in each bounce. ``cfg`` is the RayConfig keywords.
    Returns (lanes that decided otherwise in some bounce, the reference's
    last state)."""
    import source_tpu_torch as T
    from source_tpu.tracer.wavefront import (
        RayConfig as JaxRayConfig, init_rays as jax_init_rays,
        trace_step as jax_trace_step,
    )
    cfg_j = JaxRayConfig(**cfg)
    cfg_t = T.RayConfig(**cfg)
    st = jax_init_rays(jnp.asarray(o), jnp.asarray(d), bins)
    with env(SOURCE_TPU_FUSED="0", SOURCE_TPU_LEAF_BVH="0"):
        step = jax_compiled(
            lambda st, u: jax_trace_step(js, cfg_j, st, None, u=u,
                                         differentiable=False),
            st, jnp.asarray(u_all[0]))
    differ = np.zeros(len(o), bool)
    for k in range(len(u_all)):
        ref = step(st, jnp.asarray(u_all[k]))
        got = T.trace_step(ts, cfg_t, T.RayState(**{
            f: torch.from_numpy(np.array(getattr(st, f)))
            for f in ("origin", "direction", "throughput", "radiance",
                      "alive", "depth", "segments", "overflow")}),
            torch.from_numpy(u_all[k]), differentiable=False)
        assert int(got.segments) == int(ref.segments)
        same = ((np.asarray(ref.alive) == got.alive.numpy())
                & (np.asarray(ref.depth) == got.depth.numpy()))
        for f in ("origin", "direction", "throughput", "radiance"):
            a, b = np.asarray(getattr(ref, f)), getattr(got, f).numpy()
            assert np.isfinite(b).all(), f
            same &= np.isclose(b, a, rtol=1e-5, atol=1e-6).all(-1)
        differ |= ~same
        assert (~same).mean() <= max_flip, k
        st = ref
    return differ, st


def euler_ratio(scene, loss, grads):
    """sum(value * gradient) over every emission row of the material table
    (surface emitters and lights: slot 0; the checkerboard: both slots;
    homogeneous volume emitters: slot 0) over 2 loss. Radiance is
    homogeneous of degree 1 in these rows, so against a zero target the
    ratio is 1."""
    from source_tpu_torch.optical.material.base import (
        MAT_CHECKERBOARD, MAT_EMITTER, MAT_EMITTER_ANISO, MAT_LIGHT,
        VOL_HOMOGENEOUS,
    )
    rows = [(m, 0) for m, t in enumerate(scene.mat_types)
            if t in (MAT_EMITTER, MAT_EMITTER_ANISO, MAT_LIGHT, MAT_CHECKERBOARD)]
    rows += [(m, 1) for m, t in enumerate(scene.mat_types)
             if t == MAT_CHECKERBOARD]
    rows += [(r[1], 0) for r in scene.volume_entities if r[2] == VOL_HOMOGENEOUS]
    assert rows
    lhs = sum(float((scene.mat_spectra[m, k] * grads["mat_spectra"][m, k]).sum())
              for m, k in set(rows))
    return lhs / (2.0 * float(loss))
