"""Per-stage device timing of the SIFT extractor.

Times cumulative sub-programs (pyramid -> +detect/refine -> +orientations
-> +descriptors -> full extract) with the k-call scan-chain methodology
(the (k=5 - k=1)/4 slope cancels dispatch and fetch overhead), so the
difference between consecutive rows is the device cost of that stage.

    python scripts/sift_profile.py [--width 1472 --height 1088 --batch 4]
"""

import argparse
import math
import os
import sys
import time
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--width", type=int, default=1472)
    p.add_argument("--height", type=int, default=1088)
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--feats", type=int, default=4096)
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args()

    import jax
    import jax.numpy as jnp

    from colmap_tpu.features import sift
    from colmap_tpu.scene import synthetic_images as synth

    ropts = synth.RoomDatasetOptions(num_images=args.batch, width=args.width,
                                     height=args.height,
                                     focal=0.8 * args.width, seed=5)
    images, _, _, _ = synth.render_room_dataset(ropts)
    imgs = (np.stack([im if im.ndim == 2 else im.mean(-1)
                      for im in images]) / 255.0).astype(np.float32)
    o = sift.SiftExtractionOptions(max_num_features=args.feats)
    S = o.octave_resolution

    def front(image):
        h, w = image.shape
        n_oct = sift._num_octaves(h, w, o.first_octave, o.num_octaves)
        if o.first_octave < 0:
            base = sift._upsample2(image)
            cur_sigma = 2.0 * sift._SIGMA_N
        else:
            base = image
            cur_sigma = sift._SIGMA_N
        base = sift._blur(base, math.sqrt(max(sift._SIGMA0 ** 2
                                              - cur_sigma ** 2, 1e-8)))
        return base, n_oct

    def pyramids(image):
        base, n_oct = front(image)
        acc = jnp.float32(0)
        for _ in range(n_oct):
            gauss = sift._build_octave(base, S)
            acc = acc + gauss[-1].sum()
            base = sift._downsample2(gauss[S])
        return acc

    def detect(image, with_refine=True):
        base, n_oct = front(image)
        acc = jnp.float32(0)
        for oct_i in range(n_oct):
            gauss = sift._build_octave(base, S)
            dog = gauss[1:] - gauss[:-1]
            cap = max(512, o.octave_capacity >> (2 * oct_i))
            s, y, x, cand_valid = sift._detect_candidates(
                dog, o.peak_threshold, cap)
            if with_refine:
                fs, fy, fx, resp, ok = sift._refine_bulk(
                    dog, s, y, x, o.peak_threshold, o.edge_threshold)
                acc = acc + jnp.where(ok & cand_valid, resp, 0.0).sum()
            else:
                acc = acc + (s + y + x).sum() + cand_valid.sum()
            base = sift._downsample2(gauss[S])
        return acc

    def upto(image, stage):
        """stage: 'ori' or 'desc' — pyramid+detect+refine+gradients+..."""
        base, n_oct = front(image)
        acc = jnp.float32(0)
        for oct_i in range(n_oct):
            gauss = sift._build_octave(base, S)
            h, w = gauss.shape[1:]
            dog = gauss[1:] - gauss[:-1]
            cap = max(512, o.octave_capacity >> (2 * oct_i))
            s, y, x, cand_valid = sift._detect_candidates(
                dog, o.peak_threshold, cap)
            fs, fy, fx, resp, ok = sift._refine_bulk(
                dog, s, y, x, o.peak_threshold, o.edge_threshold)
            ok &= cand_valid
            keep = max(1024, cap // 2)
            if keep < fs.shape[0]:
                score = jnp.where(ok, resp, -1.0)
                _, sel = jax.lax.top_k(score, keep)
                fs, fy, fx = fs[sel], fy[sel], fx[sel]
                resp, ok = resp[sel], ok[sel]
            sigma_oct = sift._SIGMA0 * jnp.exp2(fs / S)
            gx, gy = sift._gradients(gauss)
            grad_flat = jnp.stack([gx.reshape(-1), gy.reshape(-1)], axis=-1)
            lvl = jnp.clip(jnp.round(fs).astype(jnp.int32), 0, S + 2)
            lvl_base = lvl * (h * w)
            grad_vol = jnp.stack([gx, gy], axis=-1) \
                if o.sampling == "window" else None
            theta, tvalid = sift._orientations_bulk(
                grad_flat, h, w, lvl_base, fy, fx, sigma_oct,
                o.max_num_orientations, grad_vol=grad_vol, lvl=lvl)
            if stage == "ori":
                acc = acc + jnp.where(tvalid, theta, 0.0).sum()
            else:
                k = fs.shape[0]
                mo = o.max_num_orientations
                n = k * mo
                rep = lambda a: jnp.broadcast_to(
                    a[:, None], (k, mo)).reshape(n)
                kp_lvl = rep(lvl) if grad_vol is not None else None
                desc = sift._descriptors_bulk(
                    grad_flat, h, w, rep(lvl_base), rep(fy), rep(fx),
                    rep(sigma_oct), theta.reshape(n), grad_vol=grad_vol,
                    lvl=kp_lvl)
                acc = acc + desc.sum()
            base = sift._downsample2(gauss[S])
        return acc

    core = sift._extract_static.__wrapped__

    stages = {
        "pyramid": pyramids,
        "detect": partial(detect, with_refine=False),
        "+refine": detect,
        "+orientations": partial(upto, stage="ori"),
        "+descriptors": partial(upto, stage="desc"),
        "full": lambda im: core(im, o)["valid"].sum().astype(jnp.float32),
    }

    B = imgs.shape[0]

    def chain_fn(fn):
        @partial(jax.jit, static_argnames=("k",))
        def chain(ims, k):
            def body(carry, _):
                out = jax.vmap(lambda im: fn(im + 0.0 * carry))(ims)
                return jnp.float32(out.sum()), None

            c, _ = jax.lax.scan(body, jnp.float32(0), None, length=k)
            return c

        return chain

    print(f"{args.batch}x{args.height}x{args.width}, {args.feats} feats")
    prev = 0.0
    for name, fn in stages.items():
        ch = chain_fn(fn)
        t_compile = time.perf_counter()
        for k in (1, 5):
            float(np.asarray(ch(imgs, k)))
        t_compile = time.perf_counter() - t_compile
        t1 = min(_rep(lambda: float(np.asarray(ch(imgs, 1))), args.reps))
        t5 = min(_rep(lambda: float(np.asarray(ch(imgs, 5))), args.reps))
        per_call = (t5 - t1) / 4
        ips = B / per_call
        print(f"{name:16s} {per_call * 1e3 / B:8.1f} ms/img "
              f"{ips:7.2f} img/s   delta {1e3 * (per_call - prev) / B:7.1f}"
              f" ms/img   (compile+warm {t_compile:.0f}s)")
        prev = per_call


def _rep(fn, n):
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append(time.perf_counter() - t0)
    return out


if __name__ == "__main__":
    main()
