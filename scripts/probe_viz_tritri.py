#!/usr/bin/env python
"""A short probe of the PyTorch port on one NVIDIA GPU before a full
chip_smoke.py run: which image libraries import (cv2, PIL, matplotlib,
imageio, pandas, scipy), the card's name and power limit, the host mesh
library's g++ build, the tritri collision term (forward and backward) at
the interaction fit's shapes (bench_config3's scene: 10 frames, the
synthetic hand's 1,552 closed faces, a 1,280-face object) for three pair
chunks with its wall, device time, launches and peak memory, and
render_scene of 5 frames of that scene (object and hand, full-image
camera) at 256^2 with its face budget.

Usage (about 30 s of work; writes a webm and a PNG to a temporary folder):
  python3 scripts/probe_viz_tritri.py
"""
import importlib
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("probe: CUDA is not available", file=sys.stderr)
        return 1
    for m in ("cv2", "PIL", "matplotlib", "imageio", "pandas", "scipy"):
        try:
            mod = importlib.import_module(m)
            print("import", m, "ok", getattr(mod, "__version__", ""))
        except ImportError as e:
            print("import", m, "missing", type(e).__name__, e)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    import chip_smoke
    from homan_tpu_torch import native
    from homan_tpu_torch.core.meshes import bumpy_potato
    from homan_tpu_torch.fit import model as M
    from homan_tpu_torch.frontend.gtsynth import make_synthetic_scene
    from homan_tpu_torch.interactions import intersect as TI
    from homan_tpu_torch.viz import render_viz as RV
    t = time.time()
    native.load_library()
    print("native build", time.time() - t)
    print(native.edt2d_squared(np.eye(4))[0])
    scene = make_synthetic_scene(
        chip_smoke.random_rotation(0), seed=0, frame_nb=10, image_size=512,
        rend_size=256, obj_mesh=bumpy_potato(3, 0.08, seed=0),
        with_full_masks=True, device="cuda")
    with torch.no_grad():
        vo, _ = M.get_verts_object(scene.init_state, scene.consts)
        vh, _ = M.get_verts_hand(scene.init_state, scene.consts, scene.cfg)
    hf = torch.as_tensor(scene.closed_hand_faces).cuda()
    of = scene.consts.faces_object.faces
    print("faces", hf.shape, of.shape)

    def term(cap):
        h = vh.clone().requires_grad_(True)
        hand = h.reshape(vo.shape[0], 1, -1, 3)[:, :, hf]
        loss = TI.pair_penetration_loss(
            hand, vo[:, of][:, None], max_pairs=cap).sum(1).mean()
        loss.backward()
        return loss

    for cap in (1 << 22, 1 << 24, 1 << 26):
        torch.cuda.reset_peak_memory_stats()
        for _ in range(4):
            torch.cuda.synchronize()
            t = time.perf_counter()
            loss = term(cap)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t
        print("tritri cap", cap, "loss", float(loss.detach()), "ms",
              dt * 1e3, "peak GB", torch.cuda.max_memory_allocated() / 1e9,
              flush=True)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA,
                             ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            h = vh.clone().requires_grad_(True)
            TI.compute_collision_loss_tritri(h, hf, vo, of, 1).backward()
        torch.cuda.synchronize()
    ka = prof.key_averages()
    busy = sum(e.self_device_time_total for e in ka
               if e.device_type == torch.autograd.DeviceType.CUDA)
    nl = sum(e.count for e in ka if e.key.startswith("cudaLaunchKernel"))
    print("tritri device ms/call", busy / 5 / 1e3, "launches/call", nl / 5)
    parts = [vo.cpu().numpy()[:5], vh.cpu().numpy()[:5]]
    faces = [of.cpu().numpy(), scene.consts.faces_hand.faces.cpu().numpy()]
    K = scene.consts.camintr[:5]
    for _ in range(3):
        b = []
        torch.cuda.synchronize()
        t = time.perf_counter()
        fr = RV.render_scene(parts, faces, ["gold", "grey"], K, 256,
                             device="cuda", budgets=b)
        torch.cuda.synchronize()
        print("render_scene 5 frames 256", time.perf_counter() - t, b,
              flush=True)
    with tempfile.TemporaryDirectory() as out:
        print(RV.make_video(fr, os.path.join(out, "probe.webm")))
        print(RV.save_image_grid({"a": fr}, os.path.join(out,
                                                         "probe_grid.png")))
    return 0


if __name__ == "__main__":
    sys.exit(main())
