"""The rasterizer kernel's cull rule (``rasterize_kernel.tile_terms``,
which ``renderloom_torch/csrc/rasterize.cu`` applies per pixel tile) on
the CPU: the plain twin evaluated with only each tile's kept terms, in
table order, equals the full twin bit for bit (NaN where it is NaN), in
every layout and label type, masks on and off, on the JAX-built tables
(``renderloom/ops/rasterize_pallas._build_tables``, deterministic and
train-mode) and on adversarial ones (``chip_smoke.adversarial_tables``:
heatmaps at d²·inv of 100-120 at a tile corner, capsules tangent to a
tile edge at their radius ± 0.5 px, zero-length segments, an invalid
frame, a NaN coordinate on an invalid joint, an invalid joint with
inv < 0, an infinite colour), at 48×64 and a ragged
45×61 (packed: 44×60), and on a compact person's tables.  And the rule
culls: on ``chip_smoke.py``'s spread poses and its person at 320×480 it
keeps under 15% of the (tile, term) pairs.  Also the count of K1's
operations from its machine code (``chip_smoke.k1_ops_from_sass``), on
a made-up listing.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import single_thread, t  # noqa: F401
from chip_smoke import _person_poses, _poses, adversarial_tables
from renderloom.ops import rasterize_pallas as RP
from renderloom_torch.ops import rasterize as R
from renderloom_torch.ops import rasterize_kernel as K

SIZES = {"even": (48, 64), "ragged": (45, 61)}


def _coords(n, H, W, seed):
    rng = np.random.default_rng(seed)
    coords = rng.uniform([-4, -4], [W + 4, H + 4], (n, 19, 2))
    conf = np.where(rng.uniform(size=(n, 19)) > 0.2, 0.9, 0.0)
    return (jnp.asarray(coords, jnp.float32), jnp.asarray(conf, jnp.float32))


def _jax_tables(kind, H, W):
    coords, conf = _coords(3, H, W, seed=4)
    if kind == "jax":
        sigma = jnp.full((19,), 5.0, jnp.float32)
        tables = jax.vmap(lambda c, cf: RP._build_tables(
            c, cf, sigma, None, None, None, H, W, 0.001, 0.001))(coords, conf)
    else:
        def one(k, c, cf):
            k_sig, k_drop, k_edge, k_blur = jax.random.split(k, 4)
            sigma = jax.random.randint(k_sig, (19,), 4, 6).astype(
                jnp.float32)
            keep_j = jax.random.uniform(k_drop, (19,)) > 0.3
            keep_e = jax.random.uniform(k_edge, (RP.E_SKEL,)) > 0.3
            part = jax.random.uniform(k_blur, (RP.E_MASK,)) < 0.5
            return RP._build_tables(c, cf, sigma, keep_j, keep_e, part, H, W,
                                    0.001, 0.001)
        tables = jax.vmap(one)(jax.random.split(jax.random.PRNGKey(3), 3),
                               coords, conf)
    return tuple(t(np.asarray(x)) for x in tables)


def _tables(kind, H, W):
    if kind == "adversarial":
        return adversarial_tables(H, W, device="cpu")
    if kind == "person":
        return K.build_tables(*_person_poses(3, H, W, seed=5, device="cpu"),
                              H, W)
    return _jax_tables(kind, H, W)


def _culled_twin(joints, skel, caps, height, width, out_dtype, emit_masks,
                 layout, brush=R.SKELETON_BRUSH):
    """``rasterize_tables_plain`` where each pixel skips the terms its tile
    does not keep: a skipped capsule's accumulation is not performed, a
    skipped gaussian's channel is 0·valid."""
    keep = K.tile_terms(joints, skel, caps, height, width,
                        emit_masks=emit_masks, layout=layout)
    th, tw = K.TILES[layout]
    per_px = {k: v.repeat_interleave(th, 1).repeat_interleave(tw, 2)
              [:, :height, :width] for k, v in keep.items()}
    F = joints.shape[0]
    ys = torch.arange(height, dtype=torch.float32)[:, None]
    xs = torch.arange(width, dtype=torch.float32)[None, :]
    at = lambda tab, i, k: tab[:, i, k].reshape(F, 1, 1)

    zeros = torch.zeros((F, height, width), dtype=torch.float32)
    racc, gacc, bacc, cnt = zeros, zeros, zeros, zeros
    for e in range(K.E_SKEL):
        on = per_px["skel"][..., e]
        ax, ay, bx, by = (at(skel, e, k) for k in range(4))
        d2 = R.segment_dist2(xs, ys, ax, ay, bx, by)
        da2 = (xs - ax) ** 2 + (ys - ay) ** 2
        db2 = (xs - bx) ** 2 + (ys - by) ** 2
        hit = ((d2 <= brush * brush) | (da2 <= (2 * brush) ** 2)
               | (db2 <= (2 * brush) ** 2))
        cover = torch.where(hit, at(skel, e, 4), zeros)
        racc = torch.where(on, racc + cover * at(skel, e, 5), racc)
        gacc = torch.where(on, gacc + cover * at(skel, e, 6), gacc)
        bacc = torch.where(on, bacc + cover * at(skel, e, 7), bacc)
        cnt = torch.where(on, cnt + cover, cnt)
    denom = torch.clamp(cnt, min=1.0)
    colors = [acc / denom for acc in (racc, gacc, bacc)]
    heat = []
    for j in range(K.J):
        d2 = (xs - at(joints, j, 0)) ** 2 + (ys - at(joints, j, 1)) ** 2
        heat.append(torch.where(
            per_px["joints"][..., j],
            torch.exp(-d2 * at(joints, j, 2)) * at(joints, j, 3),
            zeros * at(joints, j, 3)))
    if layout == "cfhw":
        out = {"heatmaps": torch.stack(heat, dim=1).to(out_dtype),
               "skeleton": torch.stack(colors, dim=1).to(out_dtype)}
    else:
        label = torch.stack([c * 2.0 - 1.0 for c in colors] + heat, dim=-1)
        if layout == "packed":
            label = label.reshape(F, height // 2, 2, width // 2, 2,
                                  K.LABEL_C).permute(0, 1, 3, 2, 4, 5).reshape(
                F, height // 2, width // 2, 4 * K.LABEL_C)
        out = {"label": label.to(out_dtype)}
    if emit_masks:
        macc, pacc = zeros, zeros
        for c in range(K.E_CAPS):
            on = per_px["caps"][..., c]
            d2 = R.segment_dist2(xs, ys, *(at(caps, c, k) for k in range(4)))
            radius = at(caps, c, 4)
            cover = torch.where(d2 <= radius * radius, at(caps, c, 5), zeros)
            macc = torch.where(on, torch.maximum(macc, cover), macc)
            pacc = torch.where(on, torch.maximum(pacc, cover * at(caps, c, 6)),
                               pacc)
        out["mask"], out["part_mask"] = macc, pacc
    return out


def _bits(x):
    return x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)


CASES = [(layout, dtype, masks)
         for layout in ("nhwc", "packed", "cfhw")
         for dtype in ("float32", "bfloat16")
         for masks in ((True,) if layout == "cfhw" else (False, True))]


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("kind", ["jax", "jax_train", "adversarial",
                                  "person"])
@pytest.mark.parametrize("layout,dtype,masks", CASES)
def test_culled_twin_equals_full_twin_bit_for_bit(layout, dtype, masks,
                                                  kind, size):
    H, W = SIZES[size]
    if layout == "packed":
        H, W = H - H % 2, W - W % 2
    tables = _tables(kind, H, W)
    args = (*tables, H, W, getattr(torch, dtype), masks)
    want = K.rasterize_tables_plain(*args, layout=layout)
    got = _culled_twin(*args, layout=layout)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape
        assert torch.equal(_bits(got[k]), _bits(want[k])), k
    if kind == "adversarial":
        label = want.get("label", want.get("heatmaps"))
        assert bool(label.float().isnan().any())      # frame 1's joint 0
        keep = K.tile_terms(*tables, H, W, emit_masks=masks, layout=layout)
        assert not bool(keep["joints"][2].any())      # frame 2 is culled
        assert not bool(keep["skel"][2, ..., :17].any())
        assert bool(keep["skel"][2, ..., 17].all())   # but for inf colour
        assert bool(keep["joints"][1, ..., 0].all())  # NaN is kept
        assert bool(keep["joints"][1, ..., 3].all())  # and inv < 0


def test_adversarial_tables_reach_both_sides_of_the_thresholds():
    """The corner heatmaps span the rule's 110 and exp's underflow, so a
    rule that skipped too early would change bits."""
    H, W = SIZES["even"]
    tables = adversarial_tables(H, W, device="cpu")
    keep = K.tile_terms(*tables, H, W)
    assert bool((~keep["joints"][0]).any())              # some tiles skip
    want = K.rasterize_tables_plain(*tables, H, W)
    heat = want["label"][0, ..., 3:]
    tiny = (heat > 0) & (heat < 1e-44)                   # denormal tails
    assert bool(tiny.any())


def _share_at_full_size(recipe, emit_masks):
    from chip_smoke import kept_share

    coords, conf = recipe(29, 320, 480, seed=0, device="cpu")
    tables = K.build_tables(coords, conf, 320, 480)
    return kept_share(K.tile_terms(*tables, 320, 480, emit_masks=emit_masks))


@pytest.mark.parametrize("emit_masks", [False, True])
def test_rule_keeps_under_15_percent_on_the_smoke_poses(emit_masks):
    share = _share_at_full_size(_poses, emit_masks)
    assert 0.0 < share < 0.15, share


@pytest.mark.parametrize("emit_masks", [False, True])
def test_rule_keeps_under_15_percent_on_a_person(emit_masks):
    share = _share_at_full_size(_person_poses, emit_masks)
    assert 0.0 < share < 0.15, share


def _listing(loops=2, expf=19):
    """A made-up SASS listing of raster_kernel<f32, nhwc> in the shape of
    the real one, then a bf16 function that must be ignored."""
    ins = ["LDC R1, c[0x0][0x28]"]

    def loop(body):
        top = len(ins)
        ins.extend(body)
        ins.append(f"@P0 BRA {top * 16:#06x}")
    loop(["FADD R2, R2, R3", "FFMA R4, R2, R3, R4", "MUFU.RCP R5, R4",
          "FCHK P0, R2, R4", "CALL.REL.NOINC 0x9990"])            # 5
    ins += ["FMNMX R2, R2, 1, !PT", "FADD R3, R3, R3", "FADD R3, R3, -1",
            "LDS.128 R8, [UR13]"]                                  # 3
    for _ in range(expf):                                          # 4 each
        ins += ["MUFU.EX2 R6, R6", "FMUL R7, R6, R6",
                "FFMA.SAT R8, -R7, R6, 0.5", "LOP3.LUT P0, RZ, R3, 0x8"]
    loop(["FADD R9, R9, R9", "@!P2 FMUL R9, R9, R9", "IADD3 R1, R1, 1"])
    if loops == 2:
        loop(["FMUL R2, R2, R2", "FSETP.GTU.AND P0, PT, R2, R3, PT",
              "CALL.REL.NOINC 0x9990"])                            # 2
    ins.append("EXIT")
    lines = [f"        /*{16 * i:04x}*/                   {t} ;"
             f"              /* 0x0000 */" for i, t in enumerate(ins)]
    head = "\t\tFunction : _ZN12_GLOBAL__N_113raster_kernelI{}Li0EEEvPKf"
    return "\n".join([head.format("f"), *lines, head.format(
        "13__nv_bfloat16"), lines[1], ""])


def test_k1_ops_from_sass_counts_the_loop_bodies():
    from chip_smoke import k1_ops_from_sass

    assert k1_ops_from_sass(_listing()) == {
        "joints": 4, "skel": 5, "caps": 2, "pixel": 3, "divide": 3}
    for broken in (_listing(loops=1), _listing(expf=18)):
        with pytest.raises(AssertionError, match="recount"):
            k1_ops_from_sass(broken)


def test_tile_grid_covers_ragged_sizes():
    tables = adversarial_tables(45, 61, device="cpu")
    for layout, (th, tw) in K.TILES.items():
        keep = K.tile_terms(*tables, 45, 61, emit_masks=True, layout=layout)
        assert keep["joints"].shape == (3, -(-45 // th), -(-61 // tw), 19)
        assert keep["skel"].shape[-1] == 18 and keep["caps"].shape[-1] == 39
