#!/usr/bin/env python3
"""K1 (``fused_bounce_fwd``) on the forward per-bounce route, tree against
tree, on one CUDA card.

    python3 dev/k1_route_ab.py PARENT_TREE . . PARENT_TREE

Each TREE is the root of a checkout of this repository (its
``source_tpu_torch`` package and ``chip_smoke.py``); each runs in a process
of its own, in the order given, on two inputs: the flagship of phase
``fusedprof`` (the glass Cornell box, 512x512 rays, 15 bins, its
configuration and uniforms) and the Cornell case of phase ``kernels``
(``RayConfig(max_depth=16, max_iters=24)``, uniforms from
``RandomState(11)``). A run takes the route as ``fused_forward_span(
span="perbounce")`` does: from ``pack_state``, K1 in place on the previous
bounce's live list until every lane is dead. It prints one JSON line a run
and input: the launches, the device time of each launch and their sum
(``chip_smoke.device_ms_chain``: the whole route a pass, 5 passes), and a
SHA-256 of every bounce's bitfield, its state after the bounce and its
sorted list. Exits 1 unless every run of an input gives the same digest,
that is unless K1 of every tree is the same function on the same schedule,
bit for bit.
"""

import hashlib
import json
import os
import subprocess
import sys


def one(root):
    """The JSON lines of one tree's run (in this process)."""
    sys.path.insert(0, os.path.abspath(root))
    import numpy as np
    import torch

    import chip_smoke as cs
    import source_tpu_torch as T
    from source_tpu_torch import scenes
    from source_tpu_torch.tracer import fused

    scene, cfg, o, d, u_fixed, _ = cs.flagship(T, fused, scenes)
    n = o.shape[0]
    cases = {"flagship": (scene, cfg, fused.pack_u(u_fixed),
                          dict(spectral_dtype=cfg.spectral_dtype))}
    cfg_k = T.RayConfig(max_depth=cs.FLAGSHIP["max_depth"], max_iters=24)
    u_k = torch.as_tensor(np.random.RandomState(11).random_sample(
        (24, fused.N_UNIFORMS, n)).astype(np.float32)).cuda()
    cases["kernels_cornell"] = (
        T.compile_scene(scenes.cornell_box(glass=True),
                        T.SpectralConfig(375.0, 740.0, cs.FLAGSHIP["bins"])),
        cfg_k, u_k, {})
    for name, (sc, c, u_p, kw) in cases.items():
        spec, entry = fused.scene_tables(sc, c)
        desc = entry["desc"]
        tab = fused.forward_table(sc, spec, entry)
        st0 = fused.pack_state(T.init_rays(o, d, cs.FLAGSHIP["bins"], **kw))

        def route(record=None):
            st, live, calls = {k: v.clone() for k, v in st0.items()}, None, 0
            for u in u_p:
                if not bool((st["aux"][0] > 0.5).any()):
                    break
                st, bits, live = fused.fused_bounce_fwd(
                    spec, tab, desc, st, u, live=live, survivors=True,
                    in_place=True)
                calls += 1
                if record is not None:
                    lanes = torch.sort(live[0][:int(live[1][0])]).values
                    for t in (bits, *(st[k] for k in fused._STATE_KEYS),
                              lanes):
                        record.update(t.cpu().numpy().tobytes())
            return calls

        digest = hashlib.sha256()
        launches = route(digest)

        def route_pass():
            box = dict(st={k: v.clone() for k, v in st0.items()}, live=None)

            def call(k):
                def fn():
                    box["st"], _b, box["live"] = fused.fused_bounce_fwd(
                        spec, tab, desc, box["st"], u_p[k], live=box["live"],
                        survivors=True, in_place=True)
                return fn
            return [call(k) for k in range(launches)]

        by_bounce = cs.device_ms_chain(route_pass)
        print(json.dumps(dict(
            tree=root, input=name, launches=launches,
            route_ms=sum(by_bounce), by_bounce_ms=by_bounce,
            digest=digest.hexdigest(), gpu=cs.gpu_line())), flush=True)


def main():
    if sys.argv[1:2] == ["--one"]:
        one(sys.argv[2])
        return 0
    runs = []
    for root in sys.argv[1:]:
        out = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", root], capture_output=True, text=True,
                             timeout=900)
        sys.stderr.write(out.stderr)
        if out.returncode != 0:
            print(f"k1_route_ab: {root} failed", file=sys.stderr)
            return 1
        for line in out.stdout.splitlines():
            print(line, flush=True)
            runs.append(json.loads(line))
    digests = {}
    for r in runs:
        digests.setdefault(r["input"], set()).add(r["digest"])
    same = all(len(v) == 1 for v in digests.values())
    print(json.dumps(dict(same_digest=same, inputs=sorted(digests))))
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
