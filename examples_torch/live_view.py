"""Watch a simulation live: terminal ANSI rendering or an HTML animation.

The reference opens a vispy OpenGL window (``field_visualizer.py``); on a
headless GPU machine the counterparts are a truecolor terminal loop and a
self-contained HTML page. Every frame is rendered on the card with a numpy
colormap (``anchor_lut``, no matplotlib); only uint8 images cross to the
host.

Usage:
  python examples_torch/live_view.py                 # 60 frames in the terminal
  python examples_torch/live_view.py --html out.html # write an HTML animation
  (add --cpu to run on the CPU)
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from lb2d_tpu_torch.models import PipeFlowObstacles, disk_mask
from lb2d_tpu_torch.utils.render import LiveView, anchor_lut


def main(html=None, num_frames=60, device="cuda", ny=256, nx=512,
         steps_per_frame=200, out=None):
    """Show ``num_frames`` frames of u in the terminal (``out``, default
    stdout) or write them to the HTML page ``html``; return the grid, the
    backend, the steps, the frame loop's MLUPS (rendering included) and,
    for a page, its path and size in bytes."""
    mask = disk_mask(nx, ny, cx=nx // 4, cy=ny // 2 + 3, radius=ny // 10)
    sim = PipeFlowObstacles(
        obstacle_mask=mask, diameter=1.5, rho=10.0, viscosity=0.12,
        pressure_grad=-2.5, pipe_length=1.5 * (nx - 1.5) / (ny - 1),
        N=ny - 1, device=device)
    lv = LiveView(sim, field="u", steps_per_frame=steps_per_frame,
                  lut=anchor_lut())
    sim.block_until_ready()
    t0 = time.perf_counter()
    if html:
        lv.to_html(html, num_frames=num_frames, fps=15)
    else:
        lv.to_terminal(num_frames=num_frames, max_cols=110, out=out)
    dt = time.perf_counter() - t0
    result = dict(grid=[sim.ny, sim.nx], backend=sim.backend,
                  steps=sim.steps_taken,
                  mlups=sim.num_cells * sim.steps_taken / dt / 1e6)
    if html:
        result.update(path=html, bytes=os.path.getsize(html))
        print(f"wrote {html} ({result['bytes'] / 1e6:.1f} MB), open in any "
              f"browser; {result['mlups']:.1f} MLUPS with the rendering")
    return result


if __name__ == "__main__":
    device = "cpu" if "--cpu" in sys.argv else "cuda"
    html = (sys.argv[sys.argv.index("--html") + 1] if "--html" in sys.argv
            else None)
    main(html, device=device)
