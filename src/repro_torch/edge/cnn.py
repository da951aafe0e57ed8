"""Edge CNN builders — 13 CNNs with the structure the paper characterizes:
separable-convolution edge models (MobileNet-family), fire-module models
(SqueezeNet-family), detection (SSD-style heads), and segmentation variants.

All specs use int8 quantized parameters/activations (bytes_per_param=1), batch=1,
matching the paper's TFLite / quantization-aware-trained deployment (§6).
"""
from __future__ import annotations

from ..core.layerspec import LayerKind, LayerSpec, ModelGraph

B = dict(bytes_per_param=1.0, bytes_per_act=1.0, batch=1)


def _conv(name, hw, cin, cout, k=3, s=1):
    return LayerSpec(name=name, kind=LayerKind.CONV2D, in_hw=hw, in_ch=cin,
                     out_ch=cout, kernel=k, stride=s, **B)


def _dw(name, hw, c, k=3, s=1):
    return LayerSpec(name=name, kind=LayerKind.DWCONV2D, in_hw=hw, in_ch=c,
                     kernel=k, stride=s, **B)


def _pw(name, hw, cin, cout):
    return LayerSpec(name=name, kind=LayerKind.PWCONV2D, in_hw=hw, in_ch=cin,
                     out_ch=cout, kernel=1, stride=1, **B)


def _fc(name, fin, fout):
    return LayerSpec(name=name, kind=LayerKind.FC, in_features=fin,
                     out_features=fout, **B)


def mobilenet_v1_like(name: str, res: int = 224, alpha: float = 1.0,
                      classes: int = 1000) -> ModelGraph:
    """MobileNetV1-style: conv stem + 13 depthwise-separable pairs + classifier."""
    def c(ch):
        return max(8, int(ch * alpha))
    layers = [_conv("stem", res, 3, c(32), k=3, s=2)]
    hw = res // 2
    plan = [  # (stride, out_ch) per dw/pw pair — MobileNetV1 table
        (1, 64), (2, 128), (1, 128), (2, 256), (1, 256), (2, 512),
        (1, 512), (1, 512), (1, 512), (1, 512), (1, 512), (2, 1024), (1, 1024)]
    cin = c(32)
    for i, (s, cout) in enumerate(plan):
        layers.append(_dw(f"dw{i}", hw, cin, k=3, s=s))
        hw = hw // s
        layers.append(_pw(f"pw{i}", hw, cin, c(cout)))
        cin = c(cout)
    layers.append(_fc("classifier", cin, classes))
    return ModelGraph(name, "cnn", layers)


def mobilenet_v2_like(name: str, res: int = 224, alpha: float = 1.0,
                      classes: int = 1000) -> ModelGraph:
    """Inverted residual blocks: pw-expand -> dw -> pw-project."""
    def c(ch):
        return max(8, int(ch * alpha))
    layers = [_conv("stem", res, 3, c(32), k=3, s=2)]
    hw = res // 2
    cin = c(32)
    # (expansion, out_ch, repeats, stride) — MobileNetV2 table
    plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    bi = 0
    for (t, cout, n, s) in plan:
        for r in range(n):
            stride = s if r == 0 else 1
            mid = cin * t
            if t != 1:
                layers.append(_pw(f"b{bi}_expand", hw, cin, mid))
            layers.append(_dw(f"b{bi}_dw", hw, mid, k=3, s=stride))
            hw = hw // stride
            layers.append(_pw(f"b{bi}_project", hw, mid, c(cout)))
            cin = c(cout)
            bi += 1
    layers.append(_pw("head_pw", hw, cin, 1280))
    layers.append(_fc("classifier", 1280, classes))
    return ModelGraph(name, "cnn", layers)


def squeezenet_like(name: str, res: int = 224, classes: int = 1000) -> ModelGraph:
    """Fire modules: squeeze 1x1 -> expand 1x1 + 3x3."""
    layers = [_conv("stem", res, 3, 64, k=3, s=2)]
    hw = res // 4  # stem + pool
    cin = 64
    fires = [(16, 64), (16, 64), (32, 128), (32, 128),
             (48, 192), (48, 192), (64, 256), (64, 256)]
    for i, (sq, ex) in enumerate(fires):
        if i in (2, 4):
            hw //= 2
        layers.append(_pw(f"fire{i}_squeeze", hw, cin, sq))
        layers.append(_pw(f"fire{i}_e1", hw, sq, ex))
        layers.append(_conv(f"fire{i}_e3", hw, sq, ex, k=3))
        cin = 2 * ex
    layers.append(_pw("head", hw, cin, classes))
    return ModelGraph(name, "cnn", layers)


def ssd_mobilenet_like(name: str, res: int = 320, alpha: float = 1.0) -> ModelGraph:
    """Detection: MobileNet backbone + SSD extra layers + box/class heads.

    The extra layers at 5x5/3x3/2x2/1x1 grids with deep channels are the
    paper's Cluster-4 population (large footprint, FLOP/B 25-64, 5-25M MACs).
    """
    g = mobilenet_v1_like("tmp", res=res, alpha=alpha, classes=0)
    layers = [l for l in g.layers if l.kind is not LayerKind.FC]
    hw = 10  # feature map after backbone (res/32)
    cin = max(8, int(1024 * alpha))
    extras = [(512, 5), (512, 5), (384, 3), (384, 3), (256, 2), (256, 1)]
    for i, (cout, out_hw) in enumerate(extras):
        layers.append(_pw(f"extra{i}_pw", hw, cin, cout // 2))
        layers.append(_conv(f"extra{i}_conv", hw, cout // 2, cout, k=3,
                            s=max(1, hw // out_hw)))
        hw = out_hw
        cin = cout
    # prediction heads over the last three scales
    for i, (c_feat, grid) in enumerate([(512, 5), (384, 3), (256, 1)]):
        layers.append(_conv(f"head{i}_box", grid, c_feat, 6 * 4, k=3))
        layers.append(_conv(f"head{i}_cls", grid, c_feat, 6 * 91, k=3))
    return ModelGraph(name, "cnn", layers)


def edge_classifier_like(name: str, res: int = 192, width: int = 64,
                         depth_mult: int = 1, classes: int = 1000) -> ModelGraph:
    """A generic edge classifier with standard convs at moderate resolution —
    populates Cluster 1 (early std conv) and Cluster 4 (deep late conv)."""
    layers = [_conv("stem", res, 3, width, k=3, s=2)]
    hw = res // 2
    cin = width
    stages = [(width, 2), (width * 2, 2), (width * 4, 3 * depth_mult),
              (width * 8, 3 * depth_mult)]
    for si, (cout, n) in enumerate(stages):
        for r in range(n):
            s = 2 if r == 0 and si > 0 else 1
            layers.append(_conv(f"s{si}_conv{r}", hw, cin, cout, k=3, s=s))
            hw //= s
            cin = cout
    layers.append(_conv("late_deep0", hw, cin, cin, k=3))
    layers.append(_conv("late_deep1", hw, cin, cin * 2, k=3, s=2))
    hw //= 2
    layers.append(_fc("classifier", cin * 2, classes))
    return ModelGraph(name, "cnn", layers)


def deeplab_like(name: str, res: int = 257, alpha: float = 1.0) -> ModelGraph:
    """Segmentation: MobileNetV2 backbone + ASPP-ish head at 1/16 resolution."""
    g = mobilenet_v2_like("tmp", res=res - 1, alpha=alpha, classes=0)
    layers = [l for l in g.layers if l.kind is not LayerKind.FC][:-1]
    hw, cin = 16, 320
    for i in range(4):
        layers.append(_conv(f"aspp{i}", hw, cin, 256, k=3))
        cin = 256
    layers.append(_pw("proj", hw, 256, 256))
    layers.append(_pw("logits", hw, 256, 21))
    return ModelGraph(name, "cnn", layers)


def build_cnns() -> list[ModelGraph]:
    """The 13 edge CNNs (CNN1..CNN13)."""
    return [
        mobilenet_v1_like("CNN1_mnv1_224", 224, 1.0),
        mobilenet_v1_like("CNN2_mnv1_192x075", 192, 0.75),
        mobilenet_v2_like("CNN3_mnv2_224", 224, 1.0),
        mobilenet_v2_like("CNN4_mnv2_192x14", 192, 1.4),
        squeezenet_like("CNN5_squeeze_224", 224),
        edge_classifier_like("CNN6_edgeclf_192", 192, width=64),
        edge_classifier_like("CNN7_edgeclf_160w96", 160, width=96),
        ssd_mobilenet_like("CNN8_ssd_mnv1_320", 320, 1.0),
        ssd_mobilenet_like("CNN9_ssd_mnv1_300x075", 300, 0.75),
        deeplab_like("CNN10_deeplab_257", 257, 1.0),
        mobilenet_v2_like("CNN11_mnv2_160x05", 160, 0.5),
        mobilenet_v1_like("CNN12_mnv1_160x05", 160, 0.5),
        deeplab_like("CNN13_deeplab_225x05", 225, 0.5),
    ]
