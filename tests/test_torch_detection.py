"""Detection: every op of the port's ops/detection_ops.py against the JAX
package's lowering of it, on seeded inputs and edge cases, and the SSD
detector at test width (tests/test_models.py:225's build: 4 classes,
64x64 images, 4 ground-truth rows, batch 2) through both packages.

Tolerances: float outputs at 1e-5 (summation order), integer and boolean
outputs exactly; NMS rows and decoded detections exactly for labels and
boxes (gathered, not computed), scores at 1e-5. SSD: programs equal;
three Adam steps in both packages, each from the JAX package's state
(carried with `load_numpy_params`): the loss at 1e-5 relative and each
gradient within 1e-5 of its largest element; the prior matches and the mined negatives
of ssd_loss exactly; then ssd_decode from the JAX state after the steps: labels and counts
exactly, boxes (decoded from the convolutions' offsets) and scores at
1e-5, and the port's NMS on the JAX package's decoded boxes and scores
bit-equal to its rows.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as pt
from paddle_tpu.framework import registry as jreg
from paddle_tpu.ops import detection_ops as jdet

import paddle_tpu_torch as ptt
from paddle_tpu_torch.core.enforce import UnavailableError
from paddle_tpu_torch.framework import registry as treg
from paddle_tpu_torch.framework.executor import as_numpy
from paddle_tpu_torch.ops import detection_ops as tdet

from tests.port_env import port_jax_compile_cache  # noqa: F401


@pytest.fixture(autouse=True)
def fresh_port_state():
    ptt.reset_default_programs()
    ptt.reset_global_scope()
    with ptt.unique_name.guard():
        yield


R = np.random.RandomState(17)


def f32(*shape):
    return R.randn(*shape).astype("float32")


def boxes(*lead, lo=0.0, hi=1.0):
    """Random valid boxes (x1 < x2, y1 < y2) in [lo, hi]."""
    a = R.uniform(lo, hi, lead + (2, 2)).astype("float32")
    a.sort(axis=-2)
    return a.transpose(*range(len(lead)), len(lead) + 1, len(lead)) \
        .reshape(lead + (4,))[..., [0, 2, 1, 3]]


def _gt_rows(b, g, pad):
    """[b, g, 4] ground truth, the last `pad` rows of each zero-area."""
    gt = boxes(b, g, lo=0.05, hi=0.95)
    gt[:, g - pad:] = 0.0
    return gt


def _feat(n, c, h, w):
    return np.zeros((n, c, h, w), "float32")


def _scores(b, c, m):
    s = R.uniform(0, 1, (b, c, m)).astype("float32")
    s[0, 1, :4] = 0.5          # ties inside one class
    s[0, 2, :] = 0.005         # a class entirely under the threshold
    return s


def _nms_boxes(b, m):
    bx = boxes(b, m, lo=0.0, hi=1.0)
    bx[0, 1] = bx[0, 0]        # a duplicate box (IoU 1)
    return bx


def _ssd_inputs(b=3, m=40, c=4, g=5):
    prior = boxes(m, lo=0.0, hi=1.0)
    gt = _gt_rows(b, g, 2)
    gt[1] = 0.0                # an image with no ground truth
    gt[2, 0] = prior[3]        # a ground-truth row equal to a prior
    lbl = R.randint(1, c, (b, g)).astype("int64")
    return {"Location": [f32(b, m, 4)], "Confidence": [f32(b, m, c)],
            "GTBox": [gt], "GTLabel": [lbl], "PriorBox": [prior],
            "PriorBoxVar": [np.tile(np.float32([0.1, 0.1, 0.2, 0.2]),
                                    (m, 1))]}


_DMAP_DET = np.float32([
    [[1, 0.9, 0.1, 0.1, 0.4, 0.4], [1, 0.8, 0.1, 0.1, 0.4, 0.4],
     [2, 0.7, 0.5, 0.5, 0.9, 0.9], [1, 0.7, 0.6, 0.6, 0.8, 0.8],
     [-1, -1, -1, -1, -1, -1]],
    [[2, 0.95, 0.2, 0.2, 0.6, 0.6], [1, 0.7, 0.0, 0.0, 0.3, 0.3],
     [0, 0.6, 0.1, 0.1, 0.2, 0.2], [2, 0.1, 0.2, 0.2, 0.6, 0.6],
     [-1, -1, -1, -1, -1, -1]]])
_DMAP_GT = np.float32([
    [[1, 0.1, 0.1, 0.4, 0.4], [2, 0.5, 0.5, 0.85, 0.9],
     [1, 0.65, 0.6, 0.8, 0.8], [0, 0, 0, 0, 0]],
    [[2, 0.25, 0.2, 0.6, 0.6], [1, 0.5, 0.5, 0.6, 0.6],
     [0, 0, 0, 0, 0], [0, 0, 0, 0, 0]]])

CASES = [
    ("iou_2d", "iou_similarity", {"X": [boxes(5)], "Y": [boxes(7)]}, {}),
    ("iou_3d_zero_area", "iou_similarity",
     {"X": [np.concatenate([boxes(2, 3), np.zeros((2, 1, 4), "float32")],
                           1)], "Y": [boxes(6)]}, {}),
    ("box_encode", "box_coder",
     {"PriorBox": [boxes(6)], "PriorBoxVar": [np.abs(f32(6, 4)) + 0.1],
      "TargetBox": [boxes(3)]}, {"code_type": "encode_center_size"}),
    ("box_encode_pixels", "box_coder",
     {"PriorBox": [boxes(6, hi=30.0)], "TargetBox": [boxes(3, hi=30.0)]},
     {"code_type": "encode_center_size", "box_normalized": False}),
    ("box_decode", "box_coder",
     {"PriorBox": [boxes(6)], "PriorBoxVar": [np.abs(f32(6, 4)) + 0.1],
      "TargetBox": [f32(2, 6, 4) * 0.5]},
     {"code_type": "decode_center_size"}),
    ("prior_box_flip_clip", "prior_box",
     {"Input": [_feat(1, 2, 4, 5)], "Image": [_feat(1, 3, 32, 40)]},
     {"min_sizes": [4.0, 9.0], "max_sizes": [9.0, 15.0],
      "aspect_ratios": [1.0, 2.0, 3.0], "flip": True, "clip": True}),
    ("prior_box_steps", "prior_box",
     {"Input": [_feat(1, 2, 3, 3)], "Image": [_feat(1, 3, 30, 30)]},
     {"min_sizes": [12.0], "aspect_ratios": [2.0], "flip": False,
      "clip": False, "step_w": 8.0, "step_h": 11.0, "offset": 0.25,
      "variances": [0.1, 0.2, 0.3, 0.4]}),
    ("density_prior_box", "density_prior_box",
     {"Input": [_feat(1, 2, 3, 4)], "Image": [_feat(1, 3, 24, 32)]},
     {"fixed_sizes": [4.0, 8.0], "fixed_ratios": [1.0, 2.0],
      "densities": [2, 1], "clip": True}),
    ("anchor_generator", "anchor_generator",
     {"Input": [_feat(1, 2, 3, 4)]},
     {"anchor_sizes": [32.0, 64.0], "aspect_ratios": [0.5, 1.0, 2.0],
      "stride": [16.0, 16.0]}),
    ("bipartite", "bipartite_match",
     {"DistMat": [R.uniform(0, 1, (2, 4, 9)).astype("float32")]},
     {"match_type": "bipartite"}),
    ("bipartite_ties_and_zeros", "bipartite_match",
     {"DistMat": [np.float32([[0.5, 0.5, 0.0, 0.2], [0.5, 0.5, 0.0, 0.0],
                              [0.0, 0.0, 0.0, 0.0]])]},
     {"match_type": "bipartite"}),
    ("per_prediction", "bipartite_match",
     {"DistMat": [R.uniform(0, 1, (2, 3, 8)).astype("float32")]},
     {"match_type": "per_prediction", "dist_threshold": 0.4}),
    ("target_assign", "target_assign",
     {"X": [f32(2, 3, 4)],
      "MatchIndices": [np.int32([[0, -1, 2, 1, -1], [-1, -1, 0, 0, 2]])]},
     {"mismatch_value": 7}),
    ("multiclass_nms", "multiclass_nms",
     {"BBoxes": [_nms_boxes(2, 30)], "Scores": [_scores(2, 4, 30)]},
     {"score_threshold": 0.01, "nms_top_k": 400, "keep_top_k": 20,
      "nms_threshold": 0.3, "background_label": 0}),
    ("multiclass_nms_pad_rows", "multiclass_nms",
     {"BBoxes": [_nms_boxes(2, 6)], "Scores": [_scores(2, 3, 6)]},
     {"score_threshold": 0.3, "nms_top_k": 4, "keep_top_k": 25,
      "nms_threshold": 0.5, "background_label": 1}),
    ("multiclass_nms_all_under_threshold", "multiclass_nms",
     {"BBoxes": [_nms_boxes(1, 8)],
      "Scores": [np.full((1, 3, 8), 0.005, "float32")]},
     {"score_threshold": 0.01, "keep_top_k": 5}),
    ("multiclass_nms_tied_scores", "multiclass_nms",
     {"BBoxes": [boxes(1, 9)], "Scores": [np.full((1, 2, 9), 0.5,
                                                  "float32")]},
     {"score_threshold": 0.01, "keep_top_k": 12, "nms_threshold": 0.4,
      "background_label": -1}),
    ("roi_pool", "roi_pool",
     {"X": [f32(2, 3, 8, 9)],
      "ROIs": [np.float32([[0, 0, 0, 7, 6], [1, 2.4, 1.6, 8.6, 7.5],
                           [1, 5, 5, 5, 5], [0, -3, 2, 20, 3]])]},
     {"pooled_height": 3, "pooled_width": 2, "spatial_scale": 1.0}),
    ("roi_pool_scaled", "roi_pool",
     {"X": [f32(1, 2, 6, 6)], "ROIs": [np.float32([[0, 4, 4, 20, 16]])]},
     {"pooled_height": 2, "pooled_width": 4, "spatial_scale": 0.25}),
    ("ssd_loss", "ssd_loss", _ssd_inputs(), {"overlap_threshold": 0.3}),
    ("ssd_loss_default_var", "ssd_loss",
     {k: v for k, v in _ssd_inputs().items() if k != "PriorBoxVar"},
     {"neg_pos_ratio": 1.5, "loc_loss_weight": 0.5, "background_label": 0}),
    ("rpn_target_assign", "rpn_target_assign",
     {"Anchor": [boxes(40, hi=64.0)],
      "GtBox": [np.concatenate([boxes(3, hi=64.0),
                                np.zeros((1, 4), "float32")])]},
     {"rpn_batch_size_per_im": 12, "rpn_positive_overlap": 0.5,
      "rpn_negative_overlap": 0.3}),
    ("rpn_target_assign_no_gt", "rpn_target_assign",
     {"Anchor": [boxes(10, hi=64.0)], "GtBox": [np.zeros((2, 4), "float32")]},
     {"rpn_batch_size_per_im": 4}),
    ("generate_proposals", "generate_proposals",
     {"Scores": [R.uniform(0, 1, (2, 30)).astype("float32")],
      "BboxDeltas": [f32(2, 30, 4) * 0.3],
      "Anchors": [boxes(30, hi=60.0)],
      "ImInfo": [np.float32([[64, 64, 1.0], [48, 56, 0.5]])]},
     {"pre_nms_top_n": 20, "post_nms_top_n": 8, "nms_thresh": 0.5,
      "min_size": 2.0}),
    ("generate_proposals_pad", "generate_proposals",
     {"Scores": [R.uniform(0, 1, (1, 6)).astype("float32")],
      "BboxDeltas": [f32(1, 6, 4) * 0.3], "Anchors": [boxes(6, hi=60.0)],
      "ImInfo": [np.float32([[64, 64, 1.0]])]},
     {"pre_nms_top_n": 10, "post_nms_top_n": 9}),
    ("detection_map", "detection_map",
     {"DetectRes": [_DMAP_DET], "Label": [_DMAP_GT]},
     {"class_num": 3, "overlap_threshold": 0.5}),
    ("detection_map_random", "detection_map",
     {"DetectRes": [np.concatenate(
         [R.randint(0, 3, (3, 10, 1)).astype("float32"),
          R.uniform(0, 1, (3, 10, 1)).round(1).astype("float32"),
          boxes(3, 10)], -1)],
      "Label": [np.concatenate([R.randint(0, 3, (3, 4, 1)).astype(
          "float32"), _gt_rows(3, 4, 1)], -1)]},
     {"class_num": 4, "overlap_threshold": 0.3}),
    ("positive_negative_pair", "positive_negative_pair",
     {"Score": [np.float32([[0.9], [0.5], [0.5], [0.1], [0.3], [0.8]])],
      "Label": [np.float32([[2], [1], [0], [1], [1], [0]])],
      "QueryID": [np.int64([[0], [0], [0], [0], [1], [1]])]}, {}),
    ("positive_negative_pair_accumulate", "positive_negative_pair",
     {"Score": [f32(5, 1)], "Label": [R.randint(0, 3, (5, 1)).astype(
         "float32")], "QueryID": [np.int64([[0], [1], [0], [1], [1]])],
      "AccumulatePositivePair": [np.float32([2])],
      "AccumulateNegativePair": [np.float32([1])],
      "AccumulateNeutralPair": [np.float32([0])]}, {}),
]


def _run_both(op_type, ins, attrs):
    jout = jreg.lookup_op(op_type).lower(
        jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
        {s: [jnp.asarray(a) for a in v] for s, v in ins.items()},
        dict(attrs))
    tout = treg.lookup_op(op_type).lower(
        treg.LowerCtx(), {s: [torch.from_numpy(np.ascontiguousarray(a))
                              for a in v] for s, v in ins.items()},
        dict(attrs))
    return jout, tout


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_detection_op_matches_jax_lowering(case):
    _, op_type, ins, attrs = case
    jout, tout = _run_both(op_type, ins, attrs)
    assert set(tout) == set(jout)
    for slot, jvals in jout.items():
        for jv, tv in zip(jvals, tout[slot]):
            jdt, tdt = str(jv.dtype), str(tv.dtype).replace("torch.", "")
            assert tdt == jdt or (jdt, tdt) == ("int32", "int64"), \
                (slot, jdt, tdt)
            jv, tv = np.asarray(jv), as_numpy(tv.detach())
            assert tv.shape == jv.shape, (slot, tv.shape, jv.shape)
            if tv.dtype.kind in "biu":
                np.testing.assert_array_equal(tv, jv, err_msg=slot)
            elif op_type == "multiclass_nms" and slot == "Out":
                # labels and boxes are picked, not computed: exactly
                np.testing.assert_array_equal(tv[..., [0, 2, 3, 4, 5]],
                                              jv[..., [0, 2, 3, 4, 5]])
                np.testing.assert_allclose(tv[..., 1], jv[..., 1],
                                           rtol=1e-5, atol=1e-6)
            else:
                np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5,
                                           err_msg=slot)


def test_nms_edge_cases_mean_what_they_say():
    """All scores under the threshold: no row, every row padding -1; tied
    scores keep the lower index first; the duplicate box is suppressed."""
    _, tout = _run_both("multiclass_nms", CASES[15][2], CASES[15][3])
    assert int(tout["NmsRoisNum"][0][0]) == 0
    assert (as_numpy(tout["Out"][0]) == -1).all()
    ins = {"BBoxes": [np.float32([[[0, 0, 1, 1], [0, 0, 1, 1],
                                   [2, 2, 3, 3]]])],
           "Scores": [np.float32([[[0.5, 0.5, 0.5]]])]}
    _, tout = _run_both("multiclass_nms", ins, {"background_label": -1,
                                                "keep_top_k": 3})
    rows = as_numpy(tout["Out"][0])[0]
    np.testing.assert_array_equal(rows[:, 2:], np.float32(
        [[0, 0, 1, 1], [2, 2, 3, 3], [-1, -1, -1, -1]]))


def test_ssd_loss_gradient_matches_jax():
    """d(loss)/d(Location, Confidence) through autograd against jax.grad,
    within 1e-5 of each gradient's largest element; matching and mining
    pass no gradient."""
    ins = _ssd_inputs()
    attrs = {"overlap_threshold": 0.3}
    rest = {s: v for s, v in ins.items() if s not in ("Location",
                                                      "Confidence")}

    def jloss(loc, conf):
        return jreg.lookup_op("ssd_loss").lower(
            jreg.LowerCtx(rng_key=jax.random.PRNGKey(0)),
            {"Location": [loc], "Confidence": [conf],
             **{s: [jnp.asarray(a) for a in v] for s, v in rest.items()}},
            dict(attrs))["Loss"][0]

    jg = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(ins["Location"][0]),
                                         jnp.asarray(ins["Confidence"][0]))
    loc = torch.from_numpy(ins["Location"][0]).requires_grad_()
    conf = torch.from_numpy(ins["Confidence"][0]).requires_grad_()
    treg.lookup_op("ssd_loss").lower(
        treg.LowerCtx(), {"Location": [loc], "Confidence": [conf],
                          **{s: [torch.from_numpy(a) for a in v]
                             for s, v in rest.items()}},
        dict(attrs))["Loss"][0].backward()
    for got, want in zip((loc.grad, conf.grad), jg):
        want = np.asarray(want)
        np.testing.assert_allclose(as_numpy(got), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def _jax_match_and_mine(ins, thr, ratio, bg=0):
    """The prior matches and the mined negatives of the JAX package's
    ssd_loss (paddle_tpu/ops/detection_ops.py:486-519), by its own
    `_iou` / `_bipartite_match_single` and the mining lines."""
    conf, gt, lbl, prior = (jnp.asarray(ins[k][0]) for k in (
        "Confidence", "GTBox", "GTLabel", "PriorBox"))
    m = prior.shape[0]

    def per_image(conf_b, gtb, gtl):
        area = jnp.maximum(gtb[:, 2] - gtb[:, 0], 0) * \
            jnp.maximum(gtb[:, 3] - gtb[:, 1], 0)
        iou = jnp.where((area > 0)[:, None], jdet._iou(gtb, prior), jdet._NEG)
        match, _ = jdet._bipartite_match_single(iou, "per_prediction", thr)
        pos = match >= 0
        target = jnp.where(pos, gtl.astype(jnp.int32)[jnp.maximum(match, 0)],
                           bg)
        logp = jax.nn.log_softmax(conf_b, axis=-1)
        ce = -jnp.take_along_axis(logp, target[:, None], axis=1)[:, 0]
        num_pos = jnp.sum(pos)
        num_neg = jnp.minimum((ratio * num_pos).astype(jnp.int32),
                              m - num_pos)
        order = jnp.argsort(-jnp.where(pos, jdet._NEG, ce))
        rank = jnp.zeros((m,), jnp.int32).at[order].set(
            jnp.arange(m, dtype=jnp.int32))
        return match, (~pos) & (rank < num_neg), ce

    return [np.asarray(a) for a in jax.vmap(per_image)(conf, gt, lbl)]


def test_ssd_matches_and_mined_negatives_equal_jax():
    """The port's ssd_match / ssd_mine give the JAX package's matches and
    mined negatives exactly, on the op's inputs and with ties: every
    negative of an image scoring the same loss (the lower index wins)."""
    ins = _ssd_inputs()
    ins["Confidence"][0][0] = 0.0               # image 0: all losses tie
    for thr, ratio in ((0.3, 3.0), (0.5, 1.5)):
        jmatch, jneg, jce = _jax_match_and_mine(ins, thr, ratio)
        match = tdet.ssd_match(torch.from_numpy(ins["GTBox"][0]),
                               torch.from_numpy(ins["PriorBox"][0]), thr)
        np.testing.assert_array_equal(as_numpy(match), jmatch)
        neg = tdet.ssd_mine(torch.from_numpy(jce.copy()), match >= 0, ratio)
        np.testing.assert_array_equal(as_numpy(neg), jneg)
        assert jneg[0].sum() > 0 and (jmatch >= 0).sum() > 0


# ---- the SSD detector at test width ---------------------------------------

SB, SG, SC, SIMG = 2, 4, 4, 64


def _ssd_programs():
    progs = []
    for pkg in (pt, ptt):
        from importlib import import_module
        ssd = import_module(pkg.__name__ + ".models.ssd")
        main, start = pkg.Program(), pkg.Program()
        with pkg.program_guard(main, start), pkg.unique_name.guard():
            loss, head = ssd.ssd_detector(num_classes=SC,
                                          image_shape=(3, SIMG, SIMG),
                                          num_gt=SG)
            pkg.optimizer.Adam(learning_rate=3e-3).minimize(loss)
            out, num = ssd.ssd_decode(*head, keep_top_k=20)
        progs.append((main, start, loss.name, [out.name, num.name]))
    return progs


def _ssd_feeds(n):
    r = np.random.RandomState(23)
    feeds = []
    for _ in range(n):
        gb = np.zeros((SB, SG, 4), "float32")
        gl = np.zeros((SB, SG), "int64")
        for b in range(SB):
            k = r.randint(1, SG)           # 1..3 boxes, the rest padding
            lo = r.uniform(0.0, 0.5, (k, 2))
            gb[b, :k] = np.concatenate([lo, lo + r.uniform(0.2, 0.5, (k, 2))],
                                       1)
            gl[b, :k] = r.randint(1, SC, k)
        feeds.append({"img": r.rand(SB, 3, SIMG, SIMG).astype("float32"),
                      "gt_box": gb, "gt_label": gl})
    return feeds


def test_ssd_programs_match():
    (jmain, jstart, _, _), (tmain, tstart, _, _) = _ssd_programs()
    assert tmain.to_json() == jmain.to_json()
    assert tstart.to_json() == jstart.to_json()


def test_ssd_steps_and_decode_match_jax():
    """3 Adam steps, each from the same state: the loss and every gradient
    each step, and the step's prior matches and mined negatives exactly
    (each package's on its own forward); then ssd_decode on a fresh batch from the JAX state after the
    steps: labels and counts exactly, decoded boxes and scores at 1e-5,
    and the NMS rows bit-equal on the same decoded inputs."""
    (jmain, jstart, loss, dec), (tmain, _, _, _) = _ssd_programs()
    jscope = pt.Scope()
    pt.Executor().run(jstart, scope=jscope)
    names = [p.name for p in tmain.all_parameters()]
    # ssd_loss's inputs, for its matches and mined negatives
    lop = next(op for op in jmain.global_block().ops
               if op.type == "ssd_loss")
    slots = ("Confidence", "GTBox", "GTLabel", "PriorBox")
    fetch = [loss] + [n + "@GRAD" for n in names] + \
        [lop.inputs[s][0] for s in slots]
    k = len(names) + 1
    jexe, texe = pt.Executor(), ptt.Executor(ptt.CPUPlace())
    *feeds, held = _ssd_feeds(4)
    for i, feed in enumerate(feeds):
        # each step from the JAX package's state: Adam's first steps
        # turn float32 rounding of near-zero gradients into lr-sized moves
        state = {n: np.asarray(jscope.get(n))
                 for n in jscope.local_var_names()}
        tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
        jout = jexe.run(jmain, feed=feed, fetch_list=fetch, scope=jscope)
        tout = texe.run(tmain, feed=feed, fetch_list=fetch, scope=tscope)
        np.testing.assert_allclose(tout[0], np.asarray(jout[0]), rtol=1e-5,
                                   err_msg=f"loss, step {i + 1}")
        for n, jg, tg in zip(names, jout[1:k], tout[1:k]):
            jg = np.asarray(jg)
            np.testing.assert_allclose(
                tg, jg, rtol=0, atol=1e-5 * max(float(np.abs(jg).max()),
                                                1e-30),
                err_msg=f"{n}@GRAD, step {i + 1}")
        # the matches and mined negatives of the step, each package on its
        # own forward's values, exactly
        jins = {s: [np.asarray(a)] for s, a in zip(slots, jout[k:])}
        jmatch, jneg, _ = _jax_match_and_mine(jins, 0.5, 3.0)
        tin = dict(zip(slots, (torch.from_numpy(np.asarray(a))
                               for a in tout[k:])))
        match = tdet.ssd_match(tin["GTBox"], tin["PriorBox"], 0.5)
        pos = match >= 0
        target = torch.where(pos, tin["GTLabel"].long().gather(
            1, match.clamp(min=0).long()), 0)
        ce = -torch.log_softmax(tin["Confidence"], -1).gather(
            -1, target[..., None])[..., 0]
        np.testing.assert_array_equal(as_numpy(match), jmatch)
        np.testing.assert_array_equal(as_numpy(tdet.ssd_mine(ce, pos, 3.0)),
                                      jneg)
        assert jmatch.max() >= 0 and jneg.any()
    state = {n: np.asarray(jscope.get(n)) for n in jscope.local_var_names()}
    tscope = ptt.load_numpy_params(state, ptt.Scope(), ptt.CPUPlace())
    # the NMS op's inputs too, from the same run (the program also takes
    # an Adam step)
    jfetch = [next(op.inputs[s][0] for op in jmain.global_block().ops
                   if op.type == "multiclass_nms") for s in ("BBoxes",
                                                             "Scores")]
    jrows, jnum, bb, sc = (np.asarray(a) for a in jexe.run(
        jmain, feed=held, fetch_list=dec + jfetch, scope=jscope))
    trows, tnum = texe.run(tmain, feed=held, fetch_list=dec, scope=tscope)
    np.testing.assert_array_equal(tnum, jnum)
    assert (jnum > 0).all()
    np.testing.assert_array_equal(trows[..., 0], jrows[..., 0])
    np.testing.assert_allclose(trows[..., 1:], jrows[..., 1:], rtol=1e-5,
                               atol=1e-6)
    # the same detections: on the JAX package's own decoded boxes and
    # scores the port's NMS picks the same rows, bit for bit
    nms_op = [op for op in tmain.global_block().ops
              if op.type == "multiclass_nms"][0]
    rows = treg.lookup_op("multiclass_nms").lower(
        treg.LowerCtx(), {"BBoxes": [torch.from_numpy(bb)],
                          "Scores": [torch.from_numpy(sc)]},
        dict(nms_op.attrs))["Out"][0]
    np.testing.assert_array_equal(as_numpy(rows), jrows)


def test_ssd_defaults_to_the_card():
    """Without a place the executor that trains SSD targets CUDAPlace(0),
    which raises where there is no card."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    ptt.models.ssd.ssd_detector(num_classes=SC, image_shape=(3, 32, 32),
                                num_gt=2)
    with pytest.raises(UnavailableError):
        ptt.Executor().run(ptt.default_startup_program())
