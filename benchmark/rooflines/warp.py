"""Work of `ops/epilogue.ibr_epilogue`, the image-based warp with its
occlusion test and packing, per step or view: one forward per render_geo
render, one backward per train step.  Counted from the function's
inputs and outputs, with the source images as float colours (no packed
table).

Forward bytes: in the buffers' depths, weights and positions (3B per
pixel), the S source images (3 floats per texel) and depth maps, the S
transforms and centres; out per pixel the median, the ray (3), the packed
warped colours (3S) and camera features (4S), the minimum depth error,
the valid indices (S) and weights (S), the first-source mask and the
median window (2).  Backward bytes: the buffers' depths and weights, the
source images, transforms and rays (2 per pixel) in again, the
cotangents of the median and the warped colours (1 + 3S per pixel) in,
the buffers' depth and weight gradients (2B per pixel) out.  Float ops
per (buffer entry, source): 67 forward, 145 backward; per (pixel,
source) 46 for the occlusion test, per pixel 2."""
FWD_OPS, BWD_OPS, OCC_OPS, PIX_OPS = 67, 145, 46, 2


def count(work: dict) -> dict:
    B, S, H, W = work["B"], work["S"], work["H"], work["W"]
    Hs, Ws = work["Hs"], work["Ws"]
    hw, texels = H * W, S * Hs * Ws
    renders = sum(1 for b in work["blends"] if b["mode"] == "render_geo")
    fwd_bytes = 4 * (3 * B * hw + 3 * texels + texels + S * 19) \
        + 4 * hw * (1 + 3 + 3 * S + 4 * S + 1 + S + S + 1 + 2)
    fwd_ops = B * hw * S * FWD_OPS + S * hw * OCC_OPS + hw * PIX_OPS
    out = {"ops": renders * fwd_ops, "bytes": renders * fwd_bytes}
    if work["kind"] == "train":
        out["ops"] += B * hw * S * BWD_OPS
        out["bytes"] += 4 * (2 * B * hw + 3 * texels + S * 16 + 2 * hw
                             + hw * (1 + 3 * S) + 2 * B * hw)
    return out
