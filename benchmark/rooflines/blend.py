"""Work of `ops/blend.blend_packed`, the per-pixel blend over one view's
packed instances, per step or view, from the reference's own blend of
the same inputs (`walked`: the positions up to each pixel's last
contributor, summed; `contrib`: the pairs that pass the alpha gate before
the stop, counted by the reference's backward).

Bytes: the 13 columns of the instance table the forward reads, the tile
ranges, the outputs (colour 3, normal 3, T 1, n_contrib 1 and the B-entry
buffers' depth, weight and position) per padded pixel; the backward reads
the 13 columns and writes the 15-column gradient table, and per pixel the
saved colour, T, n_contrib and the colour and T cotangents (9 values),
in render_geo also normal, its cotangent, the buffer weights and positions
and their depth and weight cotangents (6 + 4B).  Float ops: 17 per walked
pair (offsets, power, the clamped exponential, the gate), the backward 94
more per contributing pair in render_geo and 63 in colour mode."""
OPS_PER_PAIR = 17
OPS_PER_CONTRIB = {"render_geo": 94, "color": 63}


def count(work: dict) -> dict:
    B, tiles = work["B"], work["tiles"]
    ops = nbytes = 0
    for b in work["blends"]:
        pix = b["pixels"]
        ops += b["walked"] * OPS_PER_PAIR
        nbytes += b["n_inst"] * 13 * 4 + tiles * 8 + pix * (8 + 3 * B) * 4
        if "contrib" in b:
            geo = b["mode"] == "render_geo"
            ops += b["walked"] * OPS_PER_PAIR \
                + b["contrib"] * OPS_PER_CONTRIB[b["mode"]]
            nbytes += (b["n_inst"] * (13 + 15) * 4 + tiles * 8
                       + pix * (9 + (6 + 4 * B if geo else 0)) * 4)
    return {"ops": ops, "bytes": nbytes}
