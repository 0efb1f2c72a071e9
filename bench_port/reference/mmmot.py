"""Plain PyTorch reference of the mmMOT network the benchmark measures.

A straightforward float32 forward of the published architecture
(Zhang et al., ICCV 2019, arXiv:1909.03850): VGG16 with BatchNorm and
skip pooling over 224x224 crops, PointNet over frustum points, gated
fusion (variant C), a subabs link head per feature branch, the dual
softmax and the new/end heads (v2, max pool), and the min-cost flow of
each frame pair solved exactly.  It imports nothing of the measured
program: it reads the raw inputs and the weights the benchmark made,
named as the benchmark lays them out (``param_shapes``), and
recomputes every derived quantity itself.

Matmuls and convolutions run with TF32 off (``exact_matmuls``).  With
``lowp`` set, the reference takes the FP8 recipe of Hopper training (the
lower-precision control of a bfloat16 configuration): every convolution
and dense layer rounds its input and weight to float8 e4m3 under a
per-tensor scale first, and the gradient that reaches its output to
float8 e5m2 under a per-tensor scale; the forward rounding passes its
gradient straight through.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

BN_EPS = 1e-5
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
VGG16 = (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
         512, 512, 512, "M")
BRANCHES = ("fused", "image", "lidar")


def vgg_plan(mcfg: dict):
    """The VGG16 plan with each width times the configuration's
    ``width_mult`` (at least 8), "M" a 2x2 max-pool."""
    mult = mcfg["appearance"].get("width_mult", 1.0)
    return tuple(x if x == "M" else max(8, int(x * mult)) for x in VGG16)


@contextlib.contextmanager
def exact_matmuls():
    """float32 matmuls and convolutions without TF32 while inside."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def fp8_round(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """``x`` rounded to ``dtype`` under a per-tensor scale that maps its
    largest magnitude to the format's largest, back in float32."""
    top = torch.finfo(dtype).max
    s = top / x.abs().amax().clamp_min(1e-30)
    return (x * s).to(dtype).float() / s


class _Fp8(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the gradient unchanged."""

    @staticmethod
    def forward(ctx, x):
        return fp8_round(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _GradE5m2(torch.autograd.Function):
    """Forward: the identity; backward: the gradient rounded to e5m2."""

    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return fp8_round(g, torch.float8_e5m2)


class Ref:
    """The reference net over a weight dict ``p`` (float32 tensors, the
    names of ``param_shapes``) and the model settings ``mcfg`` (the
    ``model`` group of a benchmark configuration).  ``train``: BatchNorm
    takes masked batch moments (the caller passes only valid rows)."""

    def __init__(self, p: Dict[str, torch.Tensor], mcfg: dict,
                 lowp: bool = False, train: bool = False):
        self.p, self.cfg, self.lowp, self.train = p, mcfg, lowp, train
        self.moments: Optional[Dict[str, tuple]] = None

    # ---- layers ---------------------------------------------------------
    def _q(self, x):
        return _Fp8.apply(x) if self.lowp else x

    def _g(self, y):
        return _GradE5m2.apply(y) if self.lowp and y.requires_grad else y

    def dense(self, name, x):
        return self._g(F.linear(self._q(x), self._q(self.p[name + ".weight"]),
                                self.p[name + ".bias"]))

    def conv(self, name, x):
        return self._g(F.conv2d(self._q(x),
                                self._q(self.p[name + ".weight"]),
                                self.p[name + ".bias"], padding=1))

    def bn(self, name, x, ch_dim: int = -1):
        """BatchNorm over channel axis ``ch_dim``: running statistics in
        eval mode, the batch's moments (every row given) in train mode."""
        shape = [1] * x.dim()
        shape[ch_dim] = -1
        if self.train:
            dims = [d for d in range(x.dim()) if d != ch_dim % x.dim()]
            mean = x.mean(dims)
            var = (x * x).mean(dims) - mean * mean
            var = var.clamp_min(0.0)
            if self.moments is not None:
                self.moments[name] = (mean.detach(), var.detach())
        else:
            mean, var = self.p[name + ".running_mean"], \
                self.p[name + ".running_var"]
        inv = torch.rsqrt(var + BN_EPS)
        return ((x - mean.view(shape)) * inv.view(shape)
                * self.p[name + ".weight"].view(shape)
                + self.p[name + ".bias"].view(shape))

    def mlp2(self, name, x):
        return self.dense(name + ".dense_1",
                          torch.relu(self.dense(name + ".dense_0", x)))

    # ---- branches -------------------------------------------------------
    def appearance(self, crops):
        """Normalised crops [n, h, w, 3] -> [n, out_dim]."""
        x = crops.permute(0, 3, 1, 2)
        stages, i = [], 0
        for item in vgg_plan(self.cfg):
            if item == "M":
                x = F.max_pool2d(x, 2)
                stages.append(x)
                continue
            x = self.conv(f"appear_net.backbone.conv_{i}", x)
            x = torch.relu(self.bn(f"appear_net.backbone.bn_{i}", x, 1))
            i += 1
        return self.skip_head(stages[-3:])

    def skip_head(self, maps):
        """The last three stage maps [n, C, H, W] -> [n, out_dim]: global
        max, a reduce Dense + BatchNorm + ReLU each, the projection."""
        pooled = []
        for j, s in enumerate(maps):
            v = s.amax(dim=(2, 3))
            v = self.dense(f"appear_net.reduce_{j}", v)
            pooled.append(torch.relu(self.bn(f"appear_net.reduce_bn_{j}", v)))
        return self.dense("appear_net.proj", torch.cat(pooled, -1))

    def pointnet(self, pts, pmask):
        """pts [n, P, 4], pmask [n, P] -> [n, out_dim]: shared MLP with
        BatchNorm (moments over valid points in train mode), masked max
        (0 where a detection holds no point), projection."""
        x = pts
        for i in range(len(self.cfg["point"]["channels"])):
            x = self.dense(f"point_net.mlp_{i}", x)
            if self.train:
                v = self.bn(f"point_net.bn_{i}", x[pmask])
                x = torch.zeros(x.shape[:-1] + (v.shape[-1],),
                                device=x.device, dtype=x.dtype)
                x[pmask] = v
                x = torch.relu(x)
            else:
                x = torch.relu(self.bn(f"point_net.bn_{i}", x))
        neg = torch.full_like(x, -1e9)
        m = torch.where(pmask[..., None], x, neg).amax(-2)
        m = torch.where(pmask.any(-1)[:, None], m, torch.zeros_like(m))
        return self.dense("point_net.proj", m)

    def fuse(self, img, lidar):
        g = torch.sigmoid(self.dense("fusion.gate", torch.cat([img, lidar],
                                                                -1)))
        fused = (g[:, 0:1] * self.dense("fusion.proj_image", img)
                 + g[:, 1:2] * self.dense("fusion.proj_lidar", lidar))
        return {"fused": fused, "image": img, "lidar": lidar}

    def extract(self, crops, pts, pmask, block: int = 64):
        """Features {fused, image, lidar} [n, D] of n valid detections; in
        eval mode the trunk runs ``block`` crops at a time."""
        if self.train or len(crops) <= block:
            img = self.appearance(crops)
        else:
            img = torch.cat([self.appearance(crops[s:s + block])
                             for s in range(0, len(crops), block)])
        return self.fuse(img, self.pointnet(pts, pmask))

    def det_logit(self, fused):
        return self.mlp2("det_head", fused)[..., 0]

    def link(self, fp: Dict, fc: Dict):
        """Raw link [Np, Nc] of one frame pair's valid detections: the
        subabs head of each branch, summed.  In train mode the heads'
        BatchNorm takes the moments of the rows of this call."""
        total = 0.0
        for b in BRANCHES:
            x = (fp[b][:, None, :] - fc[b][None, :, :]).abs()
            x = self.dense(f"affinity_{b}.head_0", x)
            x = torch.relu(self.bn(f"affinity_{b}.head_bn_0", x))
            total = total + self.dense(f"affinity_{b}.head_out", x)[..., 0]
        return total

    def new_end(self, fp, fc, link):
        """(new [Nc], end [Np]) logits, v2 with the max pool of the link."""
        np_, nc = link.shape
        row = link.amax(1) if nc else torch.zeros(np_, device=link.device)
        col = link.amax(0) if np_ else torch.zeros(nc, device=link.device)
        new = self.mlp2("new_end.new_mlp", torch.cat([fc, col[:, None]], -1))
        end = self.mlp2("new_end.end_mlp", torch.cat([fp, row[:, None]], -1))
        return new[:, 0], end[:, 0]


# The fit of random weights to the traffic (``fit_to_traffic``).  Its
# detections: the first FIT_ROWS valid ones of the traffic.  Random
# running statistics leave the fusion gates and the heads saturated
# (fused embeddings of norm 1e-6 beside 60), so every BatchNorm takes
# the moments of its input there, as a trained net's match its data.
FIT_ROWS = 64
# The spread of the summed raw link and of the det logits there: a
# trained net's scores have a fixed spread, while free head scales make
# the LP's difficulty swing from seed to seed (64 to 4,992 auction
# rounds a window), and a saturated det head gets no gradient from the
# program's bfloat16 logistic loss.
LINK_STD = 2.0
# The median new and end sigmoid there: half of them under a tenth.
BIRTH_DEATH = 0.1


@torch.no_grad()
def fit_to_traffic(p: Dict[str, torch.Tensor], mcfg: dict, crops, pts,
                   pmask) -> Dict[str, torch.Tensor]:
    """``p`` fitted to n sample detections (crops [n, h, w, 3], points
    [n, P, 4], pmask [n, P]) as a trained net's statistics fit its data:
    every BatchNorm's running statistics set to the moments its input
    takes on them (the link heads' on the pairs between the first and
    the second half of them); each link head's output layer scaled so
    that the summed raw link over those pairs has the standard deviation
    ``LINK_STD``, the det head's so that its logits there have that
    spread too and a median of 0; the new and end heads' output biases
    moved so that their sigmoids' median on those detections is
    ``BIRTH_DEATH``."""
    ref = Ref(p, mcfg, train=True)
    ref.moments = {}
    with exact_matmuls():
        f = ref.extract(crops, pts, pmask)
        h = len(crops) // 2
        fp = {k: v[:h] for k, v in f.items()}
        fc = {k: v[h:] for k, v in f.items()}
        ref.link(fp, fc)
    out = dict(p)
    for name, (mean, var) in ref.moments.items():
        out[name + ".running_mean"] = mean.float().contiguous()
        out[name + ".running_var"] = var.float().contiguous()
    ref = Ref(out, mcfg)
    with exact_matmuls():
        scale = LINK_STD / float(ref.link(fp, fc).std().clamp_min(1e-12))
        for b in BRANCHES:
            for leaf in ("weight", "bias"):
                k = f"affinity_{b}.head_out.{leaf}"
                out[k] = out[k] * scale
        det = ref.det_logit(f["fused"])
        k = "det_head.dense_1."
        out[k + "weight"] = out[k + "weight"] * (
            LINK_STD / float(det.std().clamp_min(1e-12)))
        out[k + "bias"] = torch.zeros_like(out[k + "bias"])
        out[k + "bias"] = -ref.det_logit(f["fused"]).median().reshape(1)
        link = ref.link(fp, fc)
        new, end = ref.new_end(fp["fused"], fc["fused"], link)
        target = float(np.log(BIRTH_DEATH / (1.0 - BIRTH_DEATH)))
        for head, logits in (("new_end.new_mlp", new), ("new_end.end_mlp",
                                                         end)):
            k = head + ".dense_1.bias"
            out[k] = out[k] + (target - logits.median())
    return out


def dual_softmax(link):
    """Mean of the row and column softmaxes of a [Np, Nc] link."""
    if link.numel() == 0:
        return link
    return 0.5 * (torch.softmax(link, 1) + torch.softmax(link, 0))


def param_shapes(mcfg: dict) -> Dict[str, tuple]:
    """Name -> shape of every weight and running statistic of the
    benchmark's mmMOT (VGG16-bn with skip pooling, PointNet, fusion C
    with the single branches kept, three subabs link heads of one hidden
    layer, new/end v2, the det head).  Linear weights are [out, in],
    convolution weights [out, in, 3, 3]."""
    s: Dict[str, tuple] = {}

    def dense(name, i, o):
        s[name + ".weight"], s[name + ".bias"] = (o, i), (o,)

    def bn(name, c):
        for k in ("weight", "bias", "running_mean", "running_var"):
            s[f"{name}.{k}"] = (c,)

    a, pt = mcfg["appearance"], mcfg["point"]
    cin, i, stage_ch = 3, 0, []
    for item in vgg_plan(mcfg):
        if item == "M":
            stage_ch.append(cin)
            continue
        s[f"appear_net.backbone.conv_{i}.weight"] = (item, cin, 3, 3)
        s[f"appear_net.backbone.conv_{i}.bias"] = (item,)
        bn(f"appear_net.backbone.bn_{i}", item)
        cin, i = item, i + 1
    red = a["reduction_dim"]
    for j, c in enumerate(stage_ch[-3:]):
        dense(f"appear_net.reduce_{j}", c, red)
        bn(f"appear_net.reduce_bn_{j}", red)
    dense("appear_net.proj", 3 * red, a["out_dim"])
    cin = 4
    for j, c in enumerate(pt["channels"]):
        dense(f"point_net.mlp_{j}", cin, c)
        bn(f"point_net.bn_{j}", c)
        cin = c
    dense("point_net.proj", cin, pt["out_dim"])
    d = mcfg["fusion"]["out_dim"]
    dense("fusion.gate", a["out_dim"] + pt["out_dim"], 2)
    dense("fusion.proj_image", a["out_dim"], d)
    dense("fusion.proj_lidar", pt["out_dim"], d)
    h = mcfg["affinity"]["hidden_dim"]
    for b in BRANCHES:
        dense(f"affinity_{b}.head_0", d, h)
        bn(f"affinity_{b}.head_bn_0", h)
        dense(f"affinity_{b}.head_out", h, 1)
    hh = mcfg["new_end"]["hidden_dim"]
    for head in ("new_end.new_mlp", "new_end.end_mlp"):
        dense(head + ".dense_0", d + 1, hh)
        dense(head + ".dense_1", hh, 1)
    dense("det_head.dense_0", d, hh)
    dense("det_head.dense_1", hh, 1)
    return s


# ---- inputs ------------------------------------------------------------

def resize_dtype(mcfg: dict):
    """The dtype of a crop's interpolation weights: bfloat16 in a
    bfloat16 configuration, which resizes its crops in it (the pixels,
    whole numbers up to 255, are exact there); exact (None) otherwise."""
    return torch.bfloat16 if mcfg.get("compute_dtype") == "bfloat16" \
        else None


def crops_of(image, boxes, size, weight_dtype=None):
    """Bilinear crops of one uint8 frame [H, W, 3] at boxes [n, 4] (l, t,
    r, b pixels), half-pixel sample centres clamped to the frame, then
    ImageNet-normalised -> [n, h, w, 3] float32.  ``weight_dtype``: the
    two taps' weights of each axis rounded to it (``resize_dtype``)."""
    H, W, _ = image.shape
    h, w = size
    img = image.float()
    dev = image.device

    def taps(lo, hi, n, limit):
        i = torch.arange(n, device=dev, dtype=torch.float64) + 0.5
        pos = lo.double()[:, None] + (hi - lo).double()[:, None] * i / n - 0.5
        pos = pos.clamp(0.0, limit - 1.0)
        p0 = pos.floor()
        frac = (pos - p0).float()
        p0 = p0.long()
        return p0, (p0 + 1).clamp(max=limit - 1), frac

    y0, y1, fy = taps(boxes[:, 1], boxes[:, 3], h, H)
    x0, x1, fx = taps(boxes[:, 0], boxes[:, 2], w, W)

    def g(ys, xs):
        return img[ys[:, :, None], xs[:, None, :]]          # [n, h, w, 3]

    def pair(f):
        w = (1 - f, f)
        if weight_dtype is None:
            return w
        return tuple(v.to(weight_dtype).float() for v in w)

    ay, by = pair(fy[:, :, None, None])
    ax, bx = pair(fx[:, None, :, None])
    out = (ay * (ax * g(y0, x0) + bx * g(y0, x1))
           + by * (ax * g(y1, x0) + bx * g(y1, x1)))
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (out / 255.0 - mean) / std


def frustum_points(cloud, boxes, proj, P):
    """The first ``P`` points of ``cloud`` [M, 4] (in cloud order) whose
    projection by ``proj`` [3, 4] falls inside each box (depth > 0.1),
    xyz centred on the centroid of those samples -> (pts [n, P, 4],
    mask [n, P])."""
    xyz = cloud[:, :3].double()
    cam = xyz @ proj[:, :3].double().T + proj[:, 3].double()
    depth = cam[:, 2]
    u = cam[:, 0] / depth.clamp_min(1e-6)
    v = cam[:, 1] / depth.clamp_min(1e-6)
    b = boxes.double()
    inside = ((u[None] >= b[:, 0:1]) & (u[None] <= b[:, 2:3])
              & (v[None] >= b[:, 1:2]) & (v[None] <= b[:, 3:4])
              & (depth[None] > 0.1))                          # [n, M]
    order = torch.cumsum(inside.long(), 1)
    take = inside & (order <= P)
    n = len(boxes)
    pts = torch.zeros((n, P, cloud.shape[1]), device=cloud.device)
    mask = torch.zeros((n, P), dtype=torch.bool, device=cloud.device)
    det, idx = take.nonzero(as_tuple=True)
    slot = order[det, idx] - 1
    pts[det, slot] = cloud[idx].float()
    mask[det, slot] = True
    cnt = mask.sum(1, keepdim=True).clamp_min(1).float()
    cen = (pts[..., :3] * mask[..., None]).sum(1) / cnt
    pts[..., :3] = (pts[..., :3] - cen[:, None]) * mask[..., None]
    return pts, mask


# ---- association -------------------------------------------------------

def pair_scores(ref: Ref, fp, fc):
    """(link_norm [Np, Nc], new [Nc], end [Np]) as the LP reads them: the
    dual-softmax link and the sigmoid of the new/end logits."""
    link = ref.link(fp, fc)
    new, end = ref.new_end(fp["fused"], fc["fused"], link)
    return dual_softmax(link), torch.sigmoid(new), torch.sigmoid(end)


def objective(link, new, end, pairs) -> float:
    """The tracking LP's objective of a partial matching ``pairs`` [(i,
    j)]: matched links, plus end for each unmatched previous detection
    and new for each unmatched current one."""
    lk, nw, ed = (x.double().cpu().numpy() for x in (link, new, end))
    mp = np.zeros(len(ed), bool)
    mc = np.zeros(len(nw), bool)
    val = 0.0
    for i, j in pairs:
        val += lk[i, j]
        mp[i] = mc[j] = True
    return float(val + ed[~mp].sum() + nw[~mc].sum())


def best_objective(link, new, end) -> float:
    """The LP's optimum: a max-weight partial matching on ``link - end -
    new`` (an assignment on the non-negative part, then the pairs that
    gain nothing dropped), exact."""
    from scipy.optimize import linear_sum_assignment

    if link.numel() == 0:
        return float(new.double().sum() + end.double().sum())
    gain = (link.double() - end.double()[:, None] - new.double()[None, :])
    g = gain.cpu().numpy()
    rows, cols = linear_sum_assignment(np.maximum(g, 0.0), maximize=True)
    pairs = [(i, j) for i, j in zip(rows, cols) if g[i, j] > 0.0]
    return objective(link, new, end, pairs)


def matching_from_ids(ids_prev, ids_curr) -> List[tuple]:
    """Pairs (i, j) of valid detections of two frames that carry the same
    track id, as indices into their valid lists."""
    where = {int(t): j for j, t in enumerate(ids_curr) if t >= 0}
    return [(i, where[int(t)]) for i, t in enumerate(ids_prev)
            if t >= 0 and int(t) in where]


def assoc_gap(ref: Ref, fp, fc, ids_prev, ids_curr) -> float:
    """How far the program's decisions of one frame pair (read from its
    ids) fall below the LP's optimum, both scored by the reference."""
    link, new, end = pair_scores(ref, fp, fc)
    got = objective(link, new, end, matching_from_ids(ids_prev, ids_curr))
    return best_objective(link, new, end) - got


def check_ids(ids: np.ndarray, det_mask: np.ndarray,
              next_id: Optional[int] = None, prev=None) -> np.ndarray:
    """Frames [T] whose ids break the tracker's rules: -1 exactly at the
    empty slots, no repeat within a frame, and each id either carried
    from the previous frame or the next fresh one in slot order.  ``prev``
    (the ids of the frame before) and ``next_id`` continue a window;
    ``next_id`` None skips the fresh-id order."""
    bad = np.zeros(len(ids), bool)
    prev_set = set() if prev is None else {int(t) for t in prev if t >= 0}
    for t in range(len(ids)):
        row, dm = ids[t], det_mask[t]
        valid = row[dm]
        if (row[~dm] != -1).any() or (valid < 0).any() or \
                len(set(valid.tolist())) != len(valid):
            bad[t] = True
        for i in valid.tolist():
            if i in prev_set or i < 0 or next_id is None:
                continue
            if i != next_id:
                bad[t] = True
            next_id = i + 1
        prev_set = {int(i) for i in valid.tolist() if i >= 0}
    return bad
