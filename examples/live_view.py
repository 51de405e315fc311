"""Live-view example — the reference's OpenGL viewer, reimagined headless.

The reference's ``example/opengl.cpp`` installs a ``pre_frame``
callback that uploads the freshly-read particle buffer into a VBO and
draws points with a density-coloured shader each frame
(opengl.cpp:105-160, shaders/vert.glsl). Rendering is thus a *client
callback*, not an engine feature.

This example demonstrates the identical hook on this engine: a
``pre_frame`` callback renders each frame's particles to a PNG
(matplotlib scatter, density colour ramp) while the device computes
the next frame. Swap the renderer for anything interactive.

    python examples/live_view.py [out_dir]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from libclsph_tpu.engine.simulation import SPHSimulation
from libclsph_tpu.engine.step import StepConfig
from libclsph_tpu.io.geo_format import density_color_ramp
from libclsph_tpu.models.presets import WATER, simulation_config
from libclsph_tpu.core.params import derive_parameters


def main(out_dir="live_frames"):
    os.makedirs(out_dir, exist_ok=True)
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        print("matplotlib not available; dumping .npy frames instead")
        plt = None

    sim = SPHSimulation(step_config=StepConfig(neighbor_impl="tiles"))
    sim.parameters = derive_parameters(
        dict(WATER), simulation_config(particles_count=4096, simulation_time=0.5)
    )
    sim.precomputed_terms = sim.parameters.precomputed()
    sim.initial_volume = sim.parameters.initial_volume
    sim.load_scene("cube.obj", scenes_dir=os.path.join(
        os.path.dirname(__file__), "..", "scenes"))

    frame = [0]

    def render(arrays, params, is_full_frame):
        i = frame[0]
        frame[0] += 1
        pos = arrays["position"]
        colors = density_color_ramp(arrays["density"])
        if plt is None:
            np.save(os.path.join(out_dir, f"frame{i:04d}.npy"), pos)
            return False
        fig, ax = plt.subplots(figsize=(5, 5))
        ax.scatter(pos[:, 0], pos[:, 1], s=2, c=np.clip(colors, 0, 1))
        ax.set_xlim(-1, 1)
        ax.set_ylim(-1.7, 0.8)
        ax.set_title(f"frame {i}")
        fig.savefig(os.path.join(out_dir, f"frame{i:04d}.png"), dpi=80)
        plt.close(fig)
        return False  # particles not modified

    sim.pre_frame = render
    sim.simulate()
    print(f"wrote {frame[0]} rendered frames to {out_dir}/")


if __name__ == "__main__":
    main(*sys.argv[1:])
