"""Edge LSTM / Transducer / RCNN builders.

Dimensioned from the paper's stated statistics:
  * each LSTM gate averages ~2.1M parameters (W_x + W_h) — §3.2.1,
  * LSTM layer footprints reach 70M parameters,
  * LSTM/Transducer layer footprints average 33.4 MB,
  * Transducers follow the mobile RNN-T structure (He et al. [24]): LSTM encoder
    stack + 2-layer LSTM prediction network + feed-forward joint.
"""
from __future__ import annotations

from ..core.layerspec import LayerKind, LayerSpec, ModelGraph

B = dict(bytes_per_param=1.0, bytes_per_act=1.0, batch=1)


def _lstm(name, fin, hidden, T):
    return LayerSpec(name=name, kind=LayerKind.LSTM, in_features=fin,
                     hidden=hidden, seq_len=T, **B)


def _fc(name, fin, fout):
    return LayerSpec(name=name, kind=LayerKind.FC, in_features=fin,
                     out_features=fout, **B)


def _embed(name, vocab, dim, T):
    return LayerSpec(name=name, kind=LayerKind.EMBEDDING, vocab=vocab,
                     out_features=dim, seq_len=T, **B)


def lstm_speech_like(name: str, hidden: int = 1280, layers_n: int = 5,
                     T: int = 150, feat: int = 240,
                     out_states: int = 8192) -> ModelGraph:
    """LVCSR acoustic model (Sak et al. [44]): stacked LSTMs + output FC."""
    layers = [_lstm("lstm0", feat, hidden, T)]
    for i in range(1, layers_n):
        layers.append(_lstm(f"lstm{i}", hidden, hidden, T))
    layers.append(_fc("output", hidden, out_states))
    return ModelGraph(name, "lstm", layers)


def lstm_translate_like(name: str, hidden: int = 1024, layers_n: int = 4,
                        T: int = 60, vocab: int = 32000) -> ModelGraph:
    """Translation-style seq2seq LSTM stack (GNMT-lite)."""
    layers = [_embed("embed", vocab, hidden, T),
              _lstm("enc0", hidden, hidden, T)]
    for i in range(1, layers_n):
        layers.append(_lstm(f"enc{i}", hidden, hidden, T))
    layers.append(_fc("softmax", hidden, vocab))
    return ModelGraph(name, "lstm", layers)


def transducer_like(name: str, enc_layers: int = 8, enc_hidden: int = 2048,
                    enc_in: int = 512, T: int = 200, U: int = 20,
                    pred_hidden: int = 2048, joint_dim: int = 640,
                    vocab: int = 4096) -> ModelGraph:
    """Mobile RNN-T (He et al. [24]): encoder + prediction + joint."""
    layers = [_lstm("enc0", enc_in, enc_hidden, T)]
    for i in range(1, enc_layers):
        layers.append(_lstm(f"enc{i}", enc_hidden, enc_hidden, T))
    layers.append(_embed("pred_embed", vocab, joint_dim, U))
    layers.append(_lstm("pred0", joint_dim, pred_hidden, U))
    layers.append(_lstm("pred1", pred_hidden, pred_hidden, U))
    layers.append(_fc("joint_enc", enc_hidden, joint_dim))
    layers.append(_fc("joint_pred", pred_hidden, joint_dim))
    layers.append(_fc("joint_out", joint_dim, vocab))
    return ModelGraph(name, "transducer", layers)


def rcnn_like(name: str, res: int = 224, alpha: float = 1.0,
              lstm_hidden: int = 1024, T: int = 16,
              classes: int = 1000) -> ModelGraph:
    """LRCN [11]: CNN feature extractor + LSTM head (image captioning / video)."""
    from .cnn import mobilenet_v1_like
    g = mobilenet_v1_like("tmp", res=res, alpha=alpha, classes=0)
    layers = [l for l in g.layers if l.kind is not LayerKind.FC]
    feat = max(8, int(1024 * alpha))
    layers.append(_fc("feat_proj", feat, lstm_hidden))
    layers.append(_lstm("lstm0", lstm_hidden, lstm_hidden, T))
    layers.append(_lstm("lstm1", lstm_hidden, lstm_hidden, T))
    layers.append(_fc("classifier", lstm_hidden, classes))
    return ModelGraph(name, "rcnn", layers)


def build_lstms() -> list[ModelGraph]:
    return [
        lstm_speech_like("LSTM1_lvcsr_1280x5", hidden=1280, layers_n=5, T=150),
        lstm_speech_like("LSTM2_lvcsr_2048x4", hidden=2048, layers_n=4, T=120,
                         out_states=4096),
        lstm_translate_like("LSTM3_nmt_1024x4", hidden=1024, layers_n=4, T=60),
        # one "large footprint" model: 8*h^2 = 67M params/layer (paper: up to 70M)
        lstm_speech_like("LSTM4_big_2900x2", hidden=2900, layers_n=2, T=80,
                         feat=512, out_states=8192),
    ]


def build_transducers() -> list[ModelGraph]:
    return [
        transducer_like("TR1_rnnt_mobile", enc_layers=8, enc_hidden=2048,
                        enc_in=512, T=200, U=20),
        transducer_like("TR2_rnnt_small", enc_layers=6, enc_hidden=1400,
                        enc_in=400, T=150, U=16, pred_hidden=1400,
                        joint_dim=512, vocab=4096),
        transducer_like("TR3_rnnt_large", enc_layers=8, enc_hidden=2560,
                        enc_in=640, T=240, U=24, pred_hidden=2560,
                        joint_dim=768, vocab=8192),
        transducer_like("TR4_rnnt_med", enc_layers=7, enc_hidden=1792,
                        enc_in=512, T=180, U=20, pred_hidden=1792,
                        joint_dim=640, vocab=4096),
    ]


def build_rcnns() -> list[ModelGraph]:
    return [
        rcnn_like("RCNN1_lrcn_224", 224, 1.0, lstm_hidden=1024, T=16),
        rcnn_like("RCNN2_lrcn_192x075", 192, 0.75, lstm_hidden=768, T=16),
        rcnn_like("RCNN3_captions", 224, 1.0, lstm_hidden=1536, T=24,
                  classes=12000),
    ]
