#!/usr/bin/env python3
"""The JAX package at the 4K operating point against ground truth, on the CPU.

The ten scenes of ``chip_smoke.py``'s phase 21 (``OP_SCENES``: seven yaws at
40 m, the yaw-30 scene at 25, 50 and 65 m; host LEDs 0b10110010), rendered
by the JAX package's ``SceneRenderer`` (3840x2160, supersample 2,
``data/cam_params.json``), each a first frame with a fresh carry through its
two-pass pipeline on the XLA path (``use_pallas_preproc=False``), scored by
``chip_smoke.score_scene``.  Prints one JSON line a scene, then the summary
(``chip_smoke.op_summary``) whose worst ``dist_aruco`` error sets phase 21's
distance bound.  About 1.5 minutes and 3 GiB on 8 CPU cores:

    python3 scripts/operating_point_jax.py
"""

import json
import os
import sys

import numpy as np

REPO = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, REPO)


def main() -> int:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from apse_uav_tpu.aruco.pipeline import ArucoPipeline, ArucoPipelineConfig, init_carry
    from apse_uav_tpu.core import camera
    from apse_uav_tpu.utils.synthetic import MarkerSpec, SceneRenderer

    mtx, dist = camera.load_camera_params(os.path.join(REPO, "data", "cam_params.json"))
    w, h = 3840, 2160
    cfg = ArucoPipelineConfig(use_pallas_preproc=False, two_pass=True)
    pipe = ArucoPipeline(mtx, dist, (w, h), cfg)
    front = jax.jit(pipe.front)
    scores, renderer = [], None
    for alt, yaw in cs.OP_SCENES:
        if renderer is None or renderer.altitude != alt:
            renderer = SceneRenderer(mtx, dist, (w, h), altitude=alt, supersample=2, cache=False)
        specs = cs.op_specs(yaw)
        img = renderer.render([MarkerSpec(s.marker_id, s.center_xy, s.yaw_deg, s.roof_halfsize, s.leds)
                               for s in specs])
        f = front(jnp.asarray(np.transpose(img, (2, 0, 1))[None]))
        _, out = pipe.scan(init_carry(cfg), f, jnp.ones(1, bool), jnp.zeros((1, 17), jnp.int32))
        s = cs.score_scene({k: np.asarray(v) for k, v in out.items()}, specs, mtx, alt)
        s["scene"] = [alt, yaw]
        scores.append(s)
        print(json.dumps(s), flush=True)
    print(json.dumps(cs.op_summary(scores)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
