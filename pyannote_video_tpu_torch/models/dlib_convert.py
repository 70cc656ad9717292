"""dlib ``.dat`` model-file conversion: copy of
``pyannote_video_tpu/models/dlib_convert.py``.

A parser (``DlibReader``) and a mirror serializer (``DlibWriter``) of dlib's
primitive serialization layer, and the container walks of the three model
files the reference loads: ``convert_shape_predictor`` /
``write_shape_predictor`` (the 68-point ERT cascade),
``convert_face_recognition`` / ``write_face_recognition`` (ResNet-29) and
``convert_mmod_detector`` / ``write_mmod_detector`` (the MMOD face net).

The converters return parameters in the JAX package's layout (nested NumPy
dicts with HWIO filters; a flat ``"s{k}/name"`` dict for a cascade), which
the port loads with ``models/nn.py:params_from_jax`` and
``models/landmarks.py:cascade_from_jax``.  The wire format, the coordinate
conversions and every field order are documented in the JAX module; the
code under this docstring is that module's, line for line
(``tests/test_torch_hygiene.py:HOST_COPIES``).  Its one package import,
``embedder.BLOCK_PLAN``, is the port's own.
"""

from __future__ import annotations

from typing import BinaryIO, Dict, List

import numpy as np


class DlibReader:
    """Reader for dlib's primitive serialization layer."""

    def __init__(self, fp: BinaryIO):
        self.fp = fp

    def read_bytes(self, n: int) -> bytes:
        data = self.fp.read(n)
        if len(data) != n:
            raise EOFError(f"expected {n} bytes, got {len(data)}")
        return data

    def read_uint(self) -> int:
        """Unsigned integer: control byte (low nibble = payload size) +
        little-endian payload."""
        control = self.read_bytes(1)[0]
        size = control & 0x0F
        if size > 8:
            raise ValueError(f"invalid dlib integer control byte: {control:#x}")
        value = 0
        for i, b in enumerate(self.read_bytes(size)):
            value |= b << (8 * i)
        return value

    def read_int(self) -> int:
        """Signed integer: sign in control-byte bit 0x80 (dlib
        ``unpack_int``: ``is_negative = size & 0x80; size &= 0x0F``)."""
        control = self.read_bytes(1)[0]
        size = control & 0x0F
        negative = bool(control & 0x80)
        if size > 8:
            raise ValueError(f"invalid dlib integer control byte: {control:#x}")
        value = 0
        for i, b in enumerate(self.read_bytes(size)):
            value |= b << (8 * i)
        return -value if negative else value

    def read_float(self) -> float:
        """float_details: mantissa and exponent as signed integers.

        Non-finite markers (float_details.h): exponent 32000 = inf,
        32001 = −inf, 32002 = nan (mantissa 0 in all three).
        """
        mantissa = self.read_int()
        exponent = self.read_int()
        if exponent == 32000:
            return float("inf")
        if exponent == 32001:
            return float("-inf")
        if exponent == 32002:
            return float("nan")
        return float(mantissa) * (2.0 ** exponent)

    def read_string(self) -> str:
        n = self.read_uint()
        return self.read_bytes(n).decode("utf-8", errors="replace")

    def read_floats(self, n: int) -> np.ndarray:
        return np.asarray([self.read_float() for _ in range(n)],
                          dtype=np.float64)

    def read_matrix(self, dtype=np.float32) -> np.ndarray:
        """matrix<T>: NEGATED dims mark the modern element format
        (matrix.h serializes ``-nr, -nc``; zero-sized matrices write 0,
        which is format-ambiguous but empty either way)."""
        rows = self.read_int()
        cols = self.read_int()
        if rows > 0 or cols > 0:
            raise ValueError(
                "legacy (pre-float_details) dlib matrix encoding — the "
                "published model files all use the modern negated-dims "
                f"format (got header {rows}, {cols})")
        rows, cols = -rows, -cols
        return self.read_floats(rows * cols).reshape(rows, cols).astype(dtype)


class DlibWriter:
    """Mirror serializer for the wire format ``DlibReader`` parses."""

    def __init__(self, fp: BinaryIO):
        self.fp = fp

    def write_uint(self, value: int) -> None:
        if value < 0:
            raise ValueError("write_uint needs a non-negative value")
        payload = b""
        v = value
        while True:  # pack_int always emits >=1 payload byte (0 -> 0x00)
            payload += bytes([v & 0xFF])
            v >>= 8
            if v == 0:
                break
        self.fp.write(bytes([len(payload)]) + payload)

    def write_int(self, value: int) -> None:
        negative = value < 0
        v = -value if negative else value
        payload = b""
        while True:
            payload += bytes([v & 0xFF])
            v >>= 8
            if v == 0:
                break
        control = len(payload) | (0x80 if negative else 0)
        self.fp.write(bytes([control]) + payload)

    def write_float(self, value: float) -> None:
        """float_details encoding — exact for float32 inputs.

        Mirrors ``convert_from_T<float>``: mantissa = frexp(v)·2^24,
        exponent = exp − 24 (so 0.0 encodes as (0, −24)); non-finite
        values use the marker exponents 32000/32001/32002.
        """
        value = float(np.float32(value))
        if not np.isfinite(value):
            self.write_int(0)
            self.write_int(32002 if np.isnan(value)
                           else (32000 if value > 0 else 32001))
            return
        mant, exp = np.frexp(value)          # value = mant * 2^exp, |mant|<1
        mantissa = int(round(mant * (1 << 24)))
        self.write_int(mantissa)
        self.write_int(int(exp) - 24)

    def write_string(self, s: str) -> None:
        raw = s.encode("utf-8")
        self.write_uint(len(raw))
        self.fp.write(raw)

    def write_floats(self, arr: np.ndarray) -> None:
        for v in np.asarray(arr, dtype=np.float32).reshape(-1):
            self.write_float(float(v))

    def write_matrix(self, arr: np.ndarray) -> None:
        arr = np.asarray(arr)
        if arr.ndim != 2:
            raise ValueError("matrix must be 2-D")
        # negated dims: the modern matrix format marker (matrix.h)
        self.write_int(-arr.shape[0])
        self.write_int(-arr.shape[1])
        self.write_floats(arr)


# ---------------------------------------------------------------------------
# shape_predictor_68_face_landmarks.dat
# ---------------------------------------------------------------------------
# Container layout (dlib/image_processing/shape_predictor.h):
#   int version (1)
#   initial_shape : matrix<float> [2*68, 1], interleaved (x0, y0, x1, y1, …)
#                   in the box-normalized [0,1]² frame
#   forests : vector<vector<regression_tree>>
#       regression_tree: vector<split_feature> (heap order, 2^depth − 1)
#                        + vector<matrix<float> [2*68, 1]> (2^depth leaves)
#       split_feature: idx1 uint, idx2 uint, thresh float
#                      (go right when feats[idx1] − feats[idx2] > thresh)
#   anchor_idx : vector<vector<uint>>   — landmark anchor per pool feature
#   deltas : vector<vector<(float x, float y)>> — offsets per pool feature
SHAPE_PREDICTOR_LAYOUT = {
    "cascade_depth": 10,
    "trees_per_cascade": 500,
    "tree_depth": 4,
    "landmarks": 68,
    "target": "models/landmarks.py params dict "
              "(mean_shape, s{k}/anchor, s{k}/offset, s{k}/i1, s{k}/i2, "
              "s{k}/thresh, s{k}/leaves)",
}


def _mirror_heap(depth: int):
    """Heap permutations mirroring a complete binary tree (recursively
    swapping every node's children).

    Traversal-polarity conversion: dlib's regression_tree sends
    ``feats[idx1] − feats[idx2] > thresh`` to the **left** child 2i+1
    (dlib/image_processing/shape_predictor.h, ``regression_tree::
    operator()``), while `landmarks.predict_cascade` sends the true
    comparison to the **right** child 2i+2.  The two traversals pick the
    same leaf on the *mirrored* tree, so imports mirror every tree's node
    heap and leaf order — and exports apply the identical permutation (the
    mirror is an involution).  Copying the heaps unchanged would make a
    genuine ``.dat`` traverse the wrong subtree at every node, which a
    round-trip test, using one traversal on both sides, cannot see.

    Returns ``(node_perm, leaf_perm)`` with ``mirrored = arr[perm]``;
    node_perm reverses order within each heap level, leaf_perm reverses
    the leaf row.
    """
    nodes = (1 << depth) - 1
    node_perm = np.empty((nodes,), dtype=np.int64)
    for lvl in range(depth):
        first = (1 << lvl) - 1
        size = 1 << lvl
        node_perm[first:first + size] = np.arange(
            first + size - 1, first - 1, -1)
    leaf_perm = np.arange((1 << depth) - 1, -1, -1)
    return node_perm, leaf_perm


def convert_shape_predictor(path: str) -> Dict:
    """shape_predictor .dat → `models/landmarks.py` params dict.

    Coordinate conversion: dlib's shape/offset/leaf values live in the
    box-normalized [0,1]² frame; our cascade runs in the centered [-1,1]²
    frame (`landmarks.py:predict_cascade`), so shapes map u → 2u−1 and the
    additive quantities (leaf deltas, pool offsets) scale ×2.  Intensity
    thresholds are frame-independent and pass through unchanged.  Tree
    heaps are mirrored to convert dlib's true-goes-left traversal into
    this cascade's true-goes-right (see `_mirror_heap`).
    """
    with open(path, "rb") as fp:
        r = DlibReader(fp)
        version = r.read_int()
        if version != 1:
            raise ValueError(f"unsupported shape_predictor version {version}")

        initial = r.read_matrix().reshape(-1)          # [136] interleaved
        n_points = initial.shape[0] // 2
        mean_shape = initial.reshape(n_points, 2) * 2.0 - 1.0

        n_stages = r.read_uint()
        forests: List[List[Dict]] = []
        for _ in range(n_stages):
            n_trees = r.read_uint()
            trees = []
            for _ in range(n_trees):
                n_splits = r.read_uint()
                i1 = np.empty((n_splits,), dtype=np.int32)
                i2 = np.empty((n_splits,), dtype=np.int32)
                th = np.empty((n_splits,), dtype=np.float32)
                for s in range(n_splits):
                    i1[s] = r.read_uint()
                    i2[s] = r.read_uint()
                    th[s] = r.read_float()
                n_leaves = r.read_uint()
                leaves = np.stack(
                    [r.read_matrix().reshape(-1) for _ in range(n_leaves)]
                )                                       # [L, 136]
                trees.append({"i1": i1, "i2": i2, "thresh": th,
                              "leaves": leaves})
            forests.append(trees)

        n_anchor_stages = r.read_uint()
        anchors = []
        for _ in range(n_anchor_stages):
            n_pool = r.read_uint()
            anchors.append(
                np.asarray([r.read_uint() for _ in range(n_pool)],
                           dtype=np.int32)
            )
        n_delta_stages = r.read_uint()
        deltas = []
        for _ in range(n_delta_stages):
            n_pool = r.read_uint()
            d = np.empty((n_pool, 2), dtype=np.float32)
            for p in range(n_pool):
                d[p, 0] = r.read_float()
                d[p, 1] = r.read_float()
            deltas.append(d)

    if not (len(forests) == len(anchors) == len(deltas)):
        raise ValueError("inconsistent cascade stage counts")

    params: Dict = {"mean_shape": mean_shape.astype(np.float32)}
    depth = None
    for k, (trees, anchor, delta) in enumerate(zip(forests, anchors, deltas)):
        n_splits = len(trees[0]["i1"])
        d = int(np.log2(n_splits + 1))
        if (1 << d) - 1 != n_splits:
            raise ValueError(f"stage {k}: {n_splits} splits is not 2^d - 1")
        if depth is None:
            depth = d
        elif depth != d:
            raise ValueError("trees of differing depth are unsupported")
        node_perm, leaf_perm = _mirror_heap(d)
        params[f"s{k}/anchor"] = anchor
        params[f"s{k}/offset"] = delta * 2.0           # [0,1] → [-1,1] frame
        params[f"s{k}/i1"] = np.stack([t["i1"][node_perm] for t in trees])
        params[f"s{k}/i2"] = np.stack([t["i2"][node_perm] for t in trees])
        params[f"s{k}/thresh"] = np.stack(
            [t["thresh"][node_perm] for t in trees])
        params[f"s{k}/leaves"] = (
            np.stack([t["leaves"][leaf_perm] for t in trees]) * 2.0
        ).astype(np.float32)
    params["n_stages"] = int(len(forests))
    params["depth"] = int(depth if depth is not None else 3)
    # dlib's shape_predictor samples feature points at the NEAREST pixel
    # (shape_predictor.h rounds the warped location); the bilinear-tail
    # sampling split is this framework's extension and is not part of the
    # wire format, so a genuine .dat serves faithfully as all-nearest.
    params["bilinear_tail"] = 0
    return params


def write_shape_predictor(path: str, params: Dict) -> None:
    """Export `models/landmarks.py` params to the shape_predictor layout
    (the reverse coordinate conversion of ``convert_shape_predictor``).

    The ``bilinear_tail`` sampling-mode extension has no slot in dlib's
    wire format and is dropped; a re-imported cascade runs all-nearest
    (dlib's sampling).  Tree heaps are mirrored back to dlib's
    true-goes-left child order (`_mirror_heap` — an involution, so
    write∘convert round-trips bit-exactly)."""
    n_stages = int(params["n_stages"])
    depth = int(params["depth"])
    node_perm, leaf_perm = _mirror_heap(depth)
    with open(path, "wb") as fp:
        w = DlibWriter(fp)
        w.write_int(1)                                   # version
        mean = (np.asarray(params["mean_shape"], np.float32) + 1.0) / 2.0
        w.write_matrix(mean.reshape(-1, 1))

        w.write_uint(n_stages)
        for k in range(n_stages):
            i1 = np.asarray(params[f"s{k}/i1"])[:, node_perm]
            i2 = np.asarray(params[f"s{k}/i2"])[:, node_perm]
            th = np.asarray(params[f"s{k}/thresh"])[:, node_perm]
            leaves = np.asarray(params[f"s{k}/leaves"])[:, leaf_perm] / 2.0
            w.write_uint(i1.shape[0])
            for t in range(i1.shape[0]):
                w.write_uint(i1.shape[1])
                for s in range(i1.shape[1]):
                    w.write_uint(int(i1[t, s]))
                    w.write_uint(int(i2[t, s]))
                    w.write_float(float(th[t, s]))
                w.write_uint(leaves.shape[1])
                for l in range(leaves.shape[1]):
                    w.write_matrix(leaves[t, l].reshape(-1, 1))

        w.write_uint(n_stages)
        for k in range(n_stages):
            anchor = np.asarray(params[f"s{k}/anchor"])
            w.write_uint(anchor.shape[0])
            for a in anchor:
                w.write_uint(int(a))
        w.write_uint(n_stages)
        for k in range(n_stages):
            offset = np.asarray(params[f"s{k}/offset"]) / 2.0
            w.write_uint(offset.shape[0])
            for p in range(offset.shape[0]):
                w.write_float(float(offset[p, 0]))
                w.write_float(float(offset[p, 1]))


# ---------------------------------------------------------------------------
# dlib_face_recognition_resnet_model_v1.dat (ResNet-29)
# ---------------------------------------------------------------------------
#: Layer stack, outermost-first as declared in dlib's
#: dnn_face_recognition_ex.cpp; the serialized STREAM runs input→output
#: (dlib's add_layer serializes its subnetwork before its own details).
#: Our embedder (models/embedder.py) implements the same stack.
RESNET29_LAYER_STACK = [
    "loss_metric", "fc_no_bias<128>", "avg_pool_everything",
    "ares_down<256>",                           # alevel0
    "ares<256>", "ares<256>", "ares_down<256>",  # alevel1
    "ares<128>", "ares<128>", "ares_down<128>",  # alevel2
    "ares<64>", "ares<64>", "ares<64>", "ares_down<64>",  # alevel3
    "ares<32>", "ares<32>", "ares<32>",          # alevel4
    "max_pool<3,3,2,2>", "relu", "affine", "con<32,7,7,2,2>",
    "input_rgb_image_sized<150>",
]

# Serialized net container: tag string per node, then that node's fields.
# Parameter-bearing tags and their field layouts (input→output order —
# dlib's add_layer serializes its subnetwork before its own details, so
# the stream runs input→output like this walk):
#   "con"    : out_ch uint, in_ch uint, nr uint, nc uint, stride_y uint,
#              stride_x uint, filters matrix [out_ch, in_ch*nr*nc],
#              biases matrix [1, out_ch]
#   "affine" : gamma matrix [1, C], beta matrix [1, C]
#   "fc"     : in uint, out uint, weights matrix [in, out]
# Structural tags carry no fields: "input", "relu", "max_pool",
# "avg_pool", "add_prev", "loss_metric".  The stream ends after
# "loss_metric".
#
# FIDELITY NOTE (PARITY.md "validation against genuine dlib bytes"): the
# layer ORDER, parameter blobs (row-major [out, in*nr*nc] filters) and
# the primitive encodings below them are pinned to dlib's documented
# formats; the per-layer framing granularity (version-suffixed tag
# strings, tensor headers, padding fields of dlib's DNN layer
# serializers) is a simplification that only a genuine ``.dat`` file can
# settle — none exists in this environment.  The shape_predictor
# container above IS byte-faithful (pinned by a hand-built fixture,
# tests/test_dlib_wire.py).


def convert_face_recognition(path: str) -> Dict:
    """ResNet-29 .dat → `models/embedder.py` params pytree.

    Walks the tag stream input→output, collecting (conv, affine) pairs and
    the final fc: conv filters transpose from dlib's
    ``[out, in*nr*nc]`` row-major blob to HWIO; each ``affine`` layer folds
    into our inference batch-norm as {scale=γ, bias=β, mean=0,
    var=1−eps} (so ``rsqrt(var+eps) == 1`` exactly —
    `models/nn.py:batch_norm`).  Conv order maps onto the stem +
    `embedder.BLOCK_PLAN` blocks (conv1, conv2 per block).
    """
    convs: List[Dict] = []
    affines: List[Dict] = []
    fc = None

    with open(path, "rb") as fp:
        r = DlibReader(fp)
        while True:
            tag = r.read_string()
            if tag == "con":
                out_ch = r.read_uint()
                in_ch = r.read_uint()
                nr = r.read_uint()
                nc = r.read_uint()
                stride_y = r.read_uint()
                stride_x = r.read_uint()
                filt = r.read_matrix().reshape(out_ch, in_ch, nr, nc)
                bias = r.read_matrix().reshape(out_ch)
                convs.append({
                    "w": np.ascontiguousarray(filt.transpose(2, 3, 1, 0)),
                    "b": bias,
                    "stride": (stride_y, stride_x),
                })
            elif tag == "affine":
                gamma = r.read_matrix().reshape(-1)
                beta = r.read_matrix().reshape(-1)
                affines.append({"gamma": gamma, "beta": beta})
            elif tag == "fc":
                n_in = r.read_uint()
                n_out = r.read_uint()
                fc = r.read_matrix().reshape(n_in, n_out)
            elif tag in ("input", "relu", "max_pool", "avg_pool",
                         "add_prev"):
                continue
            elif tag == "loss_metric":
                break
            else:
                raise ValueError(f"unknown layer tag {tag!r}")

    from .embedder import BLOCK_PLAN

    n_convs_needed = 1 + 2 * len(BLOCK_PLAN)
    if len(convs) != n_convs_needed or len(affines) != n_convs_needed:
        raise ValueError(
            f"expected {n_convs_needed} conv/affine pairs "
            f"(got {len(convs)} convs, {len(affines)} affines)"
        )
    if fc is None:
        raise ValueError("missing fc layer")

    eps = 1e-5

    def bn_of(aff: Dict) -> Dict:
        c = aff["gamma"].shape[0]
        return {
            "scale": aff["gamma"].astype(np.float32),
            "bias": aff["beta"].astype(np.float32),
            "mean": np.zeros((c,), dtype=np.float32),
            "var": np.full((c,), 1.0 - eps, dtype=np.float32),
        }

    params: Dict = {
        "stem": {"w": convs[0]["w"].astype(np.float32),
                 "b": convs[0]["b"].astype(np.float32)},
        "stem_bn": bn_of(affines[0]),
        "fc": fc.astype(np.float32),
    }
    blocks: Dict = {}
    for i in range(len(BLOCK_PLAN)):
        c1, c2 = convs[1 + 2 * i], convs[2 + 2 * i]
        a1, a2 = affines[1 + 2 * i], affines[2 + 2 * i]
        blocks[f"block{i}"] = {
            "conv1": {"w": c1["w"].astype(np.float32),
                      "b": c1["b"].astype(np.float32)},
            "bn1": bn_of(a1),
            "conv2": {"w": c2["w"].astype(np.float32),
                      "b": c2["b"].astype(np.float32)},
            "bn2": bn_of(a2),
        }
    params["blocks"] = blocks
    # dlib's net emits UNnormalised embeddings; the reference's 0.6
    # Euclidean clustering threshold is calibrated on those.  The flag
    # makes `embedder.forward` skip its L2-normalisation head (which is
    # only for the synthetic-trained checkpoints).
    params["normalized_head"] = np.zeros((), dtype=np.float32)
    return params


def write_face_recognition(path: str, params: Dict) -> None:
    """Export embedder params to the ResNet-29 container layout (exact
    reverse of ``convert_face_recognition``; batch-norm statistics fold
    into the affine: γ = scale·rsqrt(var+eps), β = bias − mean·γ)."""
    from .embedder import BLOCK_PLAN

    eps = 1e-5

    def aff_of(bn: Dict):
        scale = np.asarray(bn["scale"], np.float64)
        var = np.asarray(bn["var"], np.float64)
        mean = np.asarray(bn["mean"], np.float64)
        bias = np.asarray(bn["bias"], np.float64)
        gamma = scale / np.sqrt(var + eps)
        beta = bias - mean * gamma
        return gamma.astype(np.float32), beta.astype(np.float32)

    def write_con(w_, conv: Dict, stride):
        filt = np.asarray(conv["w"])                 # HWIO
        nr, nc, in_ch, out_ch = filt.shape
        w_.write_string("con")
        w_.write_uint(out_ch)
        w_.write_uint(in_ch)
        w_.write_uint(nr)
        w_.write_uint(nc)
        w_.write_uint(stride[0])
        w_.write_uint(stride[1])
        blob = np.ascontiguousarray(filt.transpose(3, 2, 0, 1))
        w_.write_matrix(blob.reshape(out_ch, in_ch * nr * nc))
        w_.write_matrix(np.asarray(conv["b"]).reshape(1, -1))

    def write_affine(w_, bn: Dict):
        gamma, beta = aff_of(bn)
        w_.write_string("affine")
        w_.write_matrix(gamma.reshape(1, -1))
        w_.write_matrix(beta.reshape(1, -1))

    with open(path, "wb") as fp:
        w = DlibWriter(fp)
        w.write_string("input")
        write_con(w, params["stem"], (2, 2))
        write_affine(w, params["stem_bn"])
        w.write_string("relu")
        w.write_string("max_pool")
        for i, down in enumerate(BLOCK_PLAN):
            blk = params["blocks"][f"block{i}"]
            stride = (2, 2) if down else (1, 1)
            write_con(w, blk["conv1"], stride)
            write_affine(w, blk["bn1"])
            w.write_string("relu")
            write_con(w, blk["conv2"], (1, 1))
            write_affine(w, blk["bn2"])
            w.write_string("add_prev")
            w.write_string("relu")
        w.write_string("avg_pool")
        fc = np.asarray(params["fc"])
        w.write_string("fc")
        w.write_uint(fc.shape[0])
        w.write_uint(fc.shape[1])
        w.write_matrix(fc)
        w.write_string("loss_metric")


# ---------------------------------------------------------------------------
# mmod_human_face_detector.dat (MMOD CNN detector)
# ---------------------------------------------------------------------------
#: Layer stack, outermost-first as declared in dlib's
#: dnn_mmod_face_detection_ex.cpp; the serialized STREAM runs input→output
#: (same add_layer convention as the ResNet-29 container above).
#: `models/detector.py` implements the same conv plan (16/32/32 stride-2
#: downsampler + 3×45 stride-1 body + 9×9 head).
MMOD_LAYER_STACK = [
    "loss_mmod", "con<1,9,9,1,1>",
    "rcon5<45>", "rcon5<45>", "rcon5<45>",       # relu<affine<con5<45>>> ×3
    "relu", "affine", "con<32,5,5,2,2>",
    "relu", "affine", "con<32,5,5,2,2>",
    "relu", "affine", "con<16,5,5,2,2>",         # downsampler
    "input_rgb_image_pyramid<pyramid_down<6>>",
]

# Serialized container: tag string per node then that node's fields, with
# the same parameter-bearing tags as the ResNet container ("con",
# "affine") plus:
#   "input_pyramid" : avg_red float, avg_green float, avg_blue float
#                     (dlib input_rgb_image_pyramid's channel means)
#   "loss_mmod"     : n_windows uint, then per window (width uint,
#                     height uint, label string); loss_per_false_alarm
#                     float, loss_per_missed_target float,
#                     truth_match_iou_threshold float,
#                     overlaps_nms (iou float, percent_covered float),
#                     overlaps_ignore (iou float, percent_covered float).
#                     The stream ends after "loss_mmod".

#: conv index → (our param key, bn key) in `detector.init_params`'s plan
_MMOD_CONV_KEYS = [("c1", "bn1"), ("c2", "bn2"), ("c3", "bn3"),
                   ("c4", "bn4"), ("c5", "bn5"), ("c6", "bn6")]


def convert_mmod_detector(path: str) -> Dict:
    """MMOD detector .dat → `models/detector.py` params pytree.

    Walks the tag stream input→output (ref load site: `face/face.py:54`).
    Six (conv, affine) body pairs map onto ``c1..c6``/``bn1..bn6``
    (filters transpose to HWIO, affines fold into inference batch-norm
    exactly as in ``convert_face_recognition``).  Intentional divergences
    from dlib, documented here because they are ARCHITECTURAL, not weight
    mappings:

    * **head**: dlib's head is a single-channel 9×9 scorer with
      fixed-window decoding; ours regresses 4 box deltas on top
      (`detector.py:73-74`).  The dlib filter lands in head channel 0 and
      the delta channels are ZEROED — ``exp(0) = 1`` makes the regressed
      window collapse to the fixed 40×40 MMOD window, i.e. a converted
      detector reproduces dlib's exact decoding semantics.
    * **pyramid**: dlib's ``pyramid_down<6>`` (ratio 5/6) vs our 3/4
      (`detector.py:42-45`) is runtime configuration, not weights; the
      loss_mmod/input metadata (windows, channel means, NMS overlaps) is
      returned under ``"mmod_meta"`` for callers that want to reproduce
      dlib's exact pyramid/NMS settings.
    """
    convs: List[Dict] = []
    affines: List[Dict] = []
    meta: Dict = {}

    with open(path, "rb") as fp:
        r = DlibReader(fp)
        while True:
            tag = r.read_string()
            if tag == "input_pyramid":
                meta["avg_rgb"] = np.asarray(
                    [r.read_float() for _ in range(3)], np.float32)
            elif tag == "con":
                out_ch = r.read_uint()
                in_ch = r.read_uint()
                nr = r.read_uint()
                nc = r.read_uint()
                stride_y = r.read_uint()
                stride_x = r.read_uint()
                filt = r.read_matrix().reshape(out_ch, in_ch, nr, nc)
                bias = r.read_matrix().reshape(out_ch)
                convs.append({
                    "w": np.ascontiguousarray(filt.transpose(2, 3, 1, 0)),
                    "b": bias,
                    "stride": (stride_y, stride_x),
                })
            elif tag == "affine":
                gamma = r.read_matrix().reshape(-1)
                beta = r.read_matrix().reshape(-1)
                affines.append({"gamma": gamma, "beta": beta})
            elif tag == "relu":
                continue
            elif tag == "loss_mmod":
                n_windows = r.read_uint()
                windows = []
                for _ in range(n_windows):
                    w_px = r.read_uint()
                    h_px = r.read_uint()
                    label = r.read_string()
                    windows.append((w_px, h_px, label))
                meta["windows"] = windows
                meta["loss_per_false_alarm"] = r.read_float()
                meta["loss_per_missed_target"] = r.read_float()
                meta["truth_match_iou_threshold"] = r.read_float()
                meta["overlaps_nms"] = (r.read_float(), r.read_float())
                meta["overlaps_ignore"] = (r.read_float(), r.read_float())
                break
            else:
                raise ValueError(f"unknown layer tag {tag!r}")

    if len(convs) != 7 or len(affines) != 6:
        raise ValueError(
            f"expected 7 convs + 6 affines (got {len(convs)}, "
            f"{len(affines)})"
        )

    eps = 1e-5

    def bn_of(aff: Dict) -> Dict:
        c = aff["gamma"].shape[0]
        return {
            "scale": aff["gamma"].astype(np.float32),
            "bias": aff["beta"].astype(np.float32),
            "mean": np.zeros((c,), dtype=np.float32),
            "var": np.full((c,), 1.0 - eps, dtype=np.float32),
        }

    params: Dict = {}
    for i, (ck, bk) in enumerate(_MMOD_CONV_KEYS):
        params[ck] = {"w": convs[i]["w"].astype(np.float32),
                      "b": convs[i]["b"].astype(np.float32)}
        params[bk] = bn_of(affines[i])

    head = convs[6]
    nr, nc, in_ch, out_ch = head["w"].shape
    if out_ch != 1:
        raise ValueError(f"MMOD head must have 1 output channel, got {out_ch}")
    head_w = np.zeros((nr, nc, in_ch, 5), dtype=np.float32)
    head_w[..., 0] = head["w"][..., 0]
    head_b = np.zeros((5,), dtype=np.float32)
    head_b[0] = head["b"][0]
    params["head"] = {"w": head_w, "b": head_b}
    params["mmod_meta"] = meta
    return params


def write_mmod_detector(path: str, params: Dict,
                        meta: Dict | None = None) -> None:
    """Export detector params to the MMOD container layout (exact reverse
    of ``convert_mmod_detector``).  The head's 4 box-delta channels have
    no slot in dlib's single-channel format and are DROPPED — an exported
    detector scores identically but decodes fixed 40×40 windows."""
    meta = dict(meta or params.get("mmod_meta") or {})
    avg_rgb = np.asarray(meta.get("avg_rgb", (122.5, 122.5, 122.5)),
                         np.float32)
    windows = meta.get("windows", [(40, 40, "")])

    eps = 1e-5

    def aff_of(bn: Dict):
        scale = np.asarray(bn["scale"], np.float64)
        var = np.asarray(bn["var"], np.float64)
        mean = np.asarray(bn["mean"], np.float64)
        bias = np.asarray(bn["bias"], np.float64)
        gamma = scale / np.sqrt(var + eps)
        beta = bias - mean * gamma
        return gamma.astype(np.float32), beta.astype(np.float32)

    def write_con(w_, conv_w, conv_b, stride):
        filt = np.asarray(conv_w)                    # HWIO
        nr, nc, in_ch, out_ch = filt.shape
        w_.write_string("con")
        w_.write_uint(out_ch)
        w_.write_uint(in_ch)
        w_.write_uint(nr)
        w_.write_uint(nc)
        w_.write_uint(stride[0])
        w_.write_uint(stride[1])
        blob = np.ascontiguousarray(filt.transpose(3, 2, 0, 1))
        w_.write_matrix(blob.reshape(out_ch, in_ch * nr * nc))
        w_.write_matrix(np.asarray(conv_b).reshape(1, -1))

    strides = [(2, 2), (2, 2), (2, 2), (1, 1), (1, 1), (1, 1)]
    with open(path, "wb") as fp:
        w = DlibWriter(fp)
        w.write_string("input_pyramid")
        for v in avg_rgb:
            w.write_float(float(v))
        for i, (ck, bk) in enumerate(_MMOD_CONV_KEYS):
            write_con(w, params[ck]["w"], params[ck]["b"], strides[i])
            gamma, beta = aff_of(params[bk])
            w.write_string("affine")
            w.write_matrix(gamma.reshape(1, -1))
            w.write_matrix(beta.reshape(1, -1))
            w.write_string("relu")
        head_w = np.asarray(params["head"]["w"])[..., :1]
        head_b = np.asarray(params["head"]["b"])[:1]
        write_con(w, head_w, head_b, (1, 1))
        w.write_string("loss_mmod")
        w.write_uint(len(windows))
        for (w_px, h_px, label) in windows:
            w.write_uint(int(w_px))
            w.write_uint(int(h_px))
            w.write_string(str(label))
        w.write_float(float(meta.get("loss_per_false_alarm", 1.0)))
        w.write_float(float(meta.get("loss_per_missed_target", 1.0)))
        w.write_float(float(meta.get("truth_match_iou_threshold", 0.5)))
        for pair_key in ("overlaps_nms", "overlaps_ignore"):
            a, b = meta.get(pair_key, (0.4, 1.0))
            w.write_float(float(a))
            w.write_float(float(b))
