"""Check and time variants of csrc/fast_nms_blur.cu on one NVIDIA GPU.

    python3 -m orb_slam2_e_tpu_torch.tools.time_kernel_variants a.cu b.cu ...

from the repository root (it reuses chip_smoke.py's scene and replay timer).
Each argument is a copy of the kernel source with the same C entry point
(another tile shape, a phase cut short by an early return, ...). For each it
prints what ptxas reports, whether the result equals the plain torch version
bit for bit (the 8-level pyramid of a 640x480 frame, six odd shapes and a
480x640 noise image), and the CUDA-graph replay time in ms of level 0, the
pyramid, the noise image and the smallest level alone, twice, all variants
in turn. `cuobjdump -sass` on the libraries it leaves under the package's
build/ directory shows the instructions per phase.
"""

from __future__ import annotations

import os
import sys

import torch


def main(sources) -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from orb_slam2_e_tpu_torch.ops import kernels, orb
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(cs.card_line())
    th = (cs.TH_HIGH, cs.TH_LOW)
    scene, poses, _ = cs.make_scene()
    img0 = torch.as_tensor(cs.grey(scene, *poses[0]), device="cuda").float()
    levels = [img0] + [
        orb.resize_bilinear(img0, int(round(cs.HEIGHT / s)),
                            int(round(cs.WIDTH / s))).contiguous()
        for s in orb.OrbExtractor().scales[1:]]
    gen = torch.Generator(device="cuda").manual_seed(0)
    noise = torch.randint(0, 256, (cs.HEIGHT, cs.WIDTH), generator=gen,
                          device="cuda").float()
    odd = [torch.randint(0, 256, shape, generator=gen, device="cuda").float()
           for shape in ((4, 4), (5, 37), (67, 130), (16, 64), (17, 65),
                         (33, 127))]
    want = kernels.fast_nms_blur_pyramid_plain(levels + odd + [noise], *th)
    timed = {"level0": levels[:1], "pyramid": levels, "noise": [noise],
             "smallest level": levels[-1:]}
    times = {src: [] for src in sources}
    for turn in range(2):
        for src in sources:
            kernels._SRC = os.path.abspath(src)
            kernels._Lib.handle = None
            if turn == 0:
                log = kernels.compile_sources([kernels._SRC])[0][1]
                print(src, [ln.strip() for ln in log.splitlines()
                            if "Used" in ln or "spill" in ln])
                got = (kernels.fast_nms_blur_pyramid(levels, *th)
                       + [kernels.fast_nms_blur(i, *th) for i in odd + [noise]])
                print(src, "bit-equal to plain:", all(
                    torch.equal(g[0], w[0]) and torch.equal(g[1], w[1])
                    for g, w in zip(got, want)))
            row = []
            for imgs in timed.values():
                offsets, total = kernels.pyramid_layout([tuple(i.shape)
                                                         for i in imgs])
                out = torch.empty((2, total), device="cuda")
                row.append(cs.replay_ms(lambda i: kernels.launch_into(
                    imgs, out[0], out[1], *th, offsets)))
            times[src].append(row)
    for src, rows in times.items():
        print(src, " | ".join(
            " ".join(f"{name} {t:.5f}" for name, t in zip(timed, row))
            for row in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
