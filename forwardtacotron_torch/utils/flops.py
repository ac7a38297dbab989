"""Analytic FLOPs / HBM-bytes accounting and roofline (MFU) reporting on
the H100.

Port of forwardtacotron_tpu/utils/flops.py. The models are closed-form
(every GEMM size is a function of config dims, token count N and frame
count T), so FLOPs are counted analytically per stage, HBM traffic is
estimated from parameter + activation bytes, and ``mfu``/``hbm_util`` fall
out of a wall-clock measurement. The arithmetic intensity names the
binding resource (compute vs HBM bandwidth) against the card's ridge point
for the dtype the work runs in.

Conventions (the JAX module's, kept so that both packages count the same
work alike): a GEMM of [m, k] @ [k, n] counts 2*m*k*n FLOPs
(multiply+add); a conv over T frames with kernel k counts 2*T*k*cin*cout.
Elementwise and transcendental work is ignored (<1% for these
GEMM-dominated models). Activation bytes count each stage's input+output
once (write+read across a fusion boundary); weights count once per
dispatch, which is what the recurrent kernels (ops/hopper/rnn.cu) do: they
keep their weight slices in shared memory for the whole sequence.

The card's peaks are NVIDIA's data-sheet figures for the H100 SXM part,
dense (no sparsity): float32 runs outside the tensor cores, TF32 and bf16
on them, each at its own rate.
"""

from dataclasses import dataclass
from typing import Any, Dict, Optional

# ------------------------------------------------------------------ chip peaks


@dataclass(frozen=True)
class ChipSpec:
    name: str
    flops_bf16: float      # FLOP/s peak (dense tensor cores, bf16 in, f32 acc)
    flops_int8: float      # FLOP/s peak for int8 inputs
    hbm_gbps: float        # HBM bandwidth, bytes/s
    hbm_bytes: float       # HBM capacity
    flops_tf32: float      # FLOP/s peak (dense tensor cores, TF32 inputs)
    flops_f32: float       # FLOP/s peak for float32 outside the tensor cores

    @property
    def ridge_bf16(self) -> float:
        """Arithmetic intensity (FLOPs/byte) above which bf16 work is
        compute-bound."""
        return self.flops_bf16 / self.hbm_gbps


# roofline_report's dtypes and the ChipSpec field of each one's peak
_PEAK_FIELDS = {'bf16': 'flops_bf16', 'int8': 'flops_int8',
               'tf32': 'flops_tf32', 'f32': 'flops_f32'}

# NVIDIA H100 SXM data sheet, dense peaks; the CPU entry is nominal, for tests
CHIP_SPECS = {
    'h100': ChipSpec('h100', flops_bf16=989e12, flops_int8=1979e12,
                     hbm_gbps=3.35e12, hbm_bytes=80e9, flops_tf32=495e12,
                     flops_f32=67e12),
    'cpu': ChipSpec('cpu', 1e12, 1e12, 100e9, 64e9, 1e12, 1e12),
}


def card_spec(name: str) -> ChipSpec:
    """The spec of a CUDA card from its name (``torch.cuda.get_device_name``):
    an H100 SXM part, which names itself "H100" with "HBM3" or "SXM"
    (e.g. ``NVIDIA H100 80GB HBM3``). Any other card raises: its peaks
    differ, and no figure here holds for it."""
    low = name.lower()
    if 'h100' in low and ('hbm3' in low or 'sxm' in low):
        return CHIP_SPECS['h100']
    raise ValueError(f'no peak figures for the card {name!r}: CHIP_SPECS '
                     'holds the H100 SXM only')


def chip_spec(device=None) -> ChipSpec:
    """The peak figures of ``device`` (resolved as the entry points resolve
    it: CUDA unless the caller names another; raises without a CUDA device).
    The CPU gives the nominal 'cpu' entry, a card ``card_spec`` of its
    name."""
    import torch

    from forwardtacotron_torch.utils.device import resolve_device
    dev = resolve_device(device)
    if dev.type == 'cpu':
        return CHIP_SPECS['cpu']
    if dev.type != 'cuda':
        raise ValueError(f'no peak figures for the device {dev}')
    return card_spec(torch.cuda.get_device_name(dev))


# ------------------------------------------------------------- FLOP primitives


def dense_flops(b: int, t: int, din: int, dout: int) -> float:
    return 2.0 * b * t * din * dout


def conv1d_flops(b: int, t: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * b * t * k * cin * cout


def bidir_rnn_flops(b: int, t: int, in_dim: int, hidden: int,
                    n_gates: int) -> float:
    """Both directions: per step, input GEMM [B,I]@[I,G] + recurrent GEMM
    [B,H]@[H,G], G = n_gates*H."""
    g = n_gates * hidden
    return 2.0 * (dense_flops(b, t, in_dim, g) + dense_flops(b, t, hidden, g))


def series_predictor_flops(b: int, n: int, emb: int, conv_dims: int,
                           rnn_dims: int) -> float:
    """models/forward_tacotron.py SeriesPredictor: 3 convs k=5 -> BiGRU ->
    Dense(1)."""
    return (conv1d_flops(b, n, emb, conv_dims, 5)
            + 2 * conv1d_flops(b, n, conv_dims, conv_dims, 5)
            + bidir_rnn_flops(b, n, conv_dims, rnn_dims, 3)
            + dense_flops(b, n, 2 * rnn_dims, 1))


def cbhg_flops(b: int, t: int, K: int, channels: int, proj1: int,
               proj2: int, num_highways: int, in_dim: int) -> float:
    """models/layers.py CBHG: conv bank k=1..K, two k=3 projections,
    pre-highway Dense, highway stack (2 Dense each), BiGRU(channels)."""
    bank = conv1d_flops(b, t, in_dim, channels, 1) * (K * (K + 1) // 2)
    projections = (conv1d_flops(b, t, K * channels, proj1, 3)
                   + conv1d_flops(b, t, proj1, proj2, 3))
    pre_highway = dense_flops(b, t, proj2, channels)
    highways = 2 * num_highways * dense_flops(b, t, channels, channels)
    rnn = bidir_rnn_flops(b, t, channels, channels, 3)
    return bank + projections + pre_highway + highways + rnn


# ------------------------------------------------- flagship model, per stage


def forward_tacotron_stage_flops(model_cfg: Dict[str, Any], b: int,
                                 n_tokens: int, t_frames: int,
                                 n_mels: int = 80) -> Dict[str, float]:
    """Per-stage FLOPs of one ForwardTacotron generate pass (batch b,
    n_tokens at token rate, t_frames at frame rate). The decode stages are
    what ``ForwardTacotron.generate`` computes, 'series_predictors' what
    ``predict_series`` computes."""
    m = model_cfg
    emb = m['embed_dims']
    semb = m['series_embed_dims']
    p = m['prenet_dims']
    stages = {
        'series_predictors': (
            series_predictor_flops(b, n_tokens, semb,
                                   m['durpred_conv_dims'],
                                   m['durpred_rnn_dims'])
            + series_predictor_flops(b, n_tokens, semb,
                                     m['pitch_conv_dims'],
                                     m['pitch_rnn_dims'])
            + series_predictor_flops(b, n_tokens, semb,
                                     m['energy_conv_dims'],
                                     m['energy_rnn_dims'])),
        'prenet_cbhg': cbhg_flops(b, n_tokens, m['prenet_k'], p,
                                  proj1=p, proj2=emb,
                                  num_highways=m['prenet_num_highways'],
                                  in_dim=emb),
        'pitch_energy_proj': 2 * conv1d_flops(b, n_tokens, 1, 2 * p, 3),
        'frame_bilstm': bidir_rnn_flops(b, t_frames, 2 * p, m['rnn_dims'],
                                        4),
        'mel_linear': dense_flops(b, t_frames, 2 * m['rnn_dims'], n_mels),
        'postnet_cbhg': cbhg_flops(b, t_frames, m['postnet_k'],
                                   m['postnet_dims'],
                                   proj1=m['postnet_dims'], proj2=n_mels,
                                   num_highways=m['postnet_num_highways'],
                                   in_dim=n_mels),
        'post_proj': dense_flops(b, t_frames, 2 * m['postnet_dims'], n_mels),
    }
    return stages


def forward_tacotron_generate_flops(config: Dict[str, Any], b: int,
                                    n_tokens: int, t_frames: int) -> float:
    stages = forward_tacotron_stage_flops(
        config['forward_tacotron']['model'], b, n_tokens, t_frames,
        n_mels=config['dsp']['num_mels'])
    return float(sum(stages.values()))


def forward_tacotron_train_flops(config: Dict[str, Any], b: int,
                                 n_tokens: int, t_frames: int) -> float:
    """One train step: forward + backward ~= 3x the forward GEMM work (the
    backward pass runs two GEMMs — dgrad and wgrad — per forward GEMM)."""
    return 3.0 * forward_tacotron_generate_flops(config, b, n_tokens,
                                                 t_frames)


def forward_tacotron_stage_bytes(model_cfg: Dict[str, Any], b: int,
                                 n_tokens: int, t_frames: int,
                                 n_mels: int = 80,
                                 dtype_bytes: int = 2) -> Dict[str, float]:
    """Per-stage HBM traffic estimate matching forward_tacotron_stage_flops'
    stage names: every inter-op activation tensor inside the stage counted
    write+read (2x) across fusion boundaries, plus stage input read, output
    write and weights once. This is the traffic of a stage whose operations
    each round-trip memory (not a perfect-fusion lower bound)."""
    m = model_cfg
    emb, semb, p = m['embed_dims'], m['series_embed_dims'], m['prenet_dims']
    d = dtype_bytes

    def sp_bytes(conv, rnn):
        # embed out, 3 conv outs (w+r), gru out (w+r), head out
        act = b * n_tokens * (2 * semb + 3 * 2 * conv + 2 * 2 * rnn + 1)
        w = 5 * semb * conv + 2 * 5 * conv * conv \
            + 2 * (conv * 3 * rnn + rnn * 3 * rnn)
        return (act + w) * d

    def cbhg_bytes(K, c, in_dim, proj2, t):
        # in read, bank concat (w+r), maxpool out (w+r), proj1 (w+r),
        # proj2+residual (w+r), highway xs (w+r, 4 stages ~ c each),
        # gru out write
        act = b * t * (in_dim + 2 * K * c + 2 * K * c + 2 * c
                       + 2 * in_dim + 8 * c + 2 * c)
        w = (in_dim * c * (K * (K + 1) // 2) + 3 * K * c * c
             + 3 * c * proj2 + proj2 * c + 8 * c * c + 2 * 2 * c * 3 * c)
        return (act + w) * d

    stages = {
        'series_predictors': (sp_bytes(m['durpred_conv_dims'],
                                       m['durpred_rnn_dims'])
                              + sp_bytes(m['pitch_conv_dims'],
                                         m['pitch_rnn_dims'])
                              + sp_bytes(m['energy_conv_dims'],
                                         m['energy_rnn_dims'])),
        'prenet_cbhg': cbhg_bytes(m['prenet_k'], p, emb, emb, n_tokens),
        'pitch_energy_proj': float(2 * b * n_tokens * (1 + 2 * p) * d),
        'length_regulator': float(
            b * (n_tokens + t_frames) * 2 * p * d),   # read tokens, write T
        'frame_bilstm': float(
            (b * t_frames * (2 * p + 2 * m['rnn_dims'])
             + 2 * (2 * p * 4 * m['rnn_dims']
                    + m['rnn_dims'] * 4 * m['rnn_dims'])) * d),
        'mel_linear': float(
            (b * t_frames * (2 * m['rnn_dims'] + n_mels)
             + 2 * m['rnn_dims'] * n_mels) * d),
        'postnet_cbhg': cbhg_bytes(m['postnet_k'], m['postnet_dims'],
                                   n_mels, n_mels, t_frames),
        'post_proj': float(
            (b * t_frames * (2 * m['postnet_dims'] + n_mels)
             + 2 * m['postnet_dims'] * n_mels) * d),
    }
    return {k: float(v) for k, v in stages.items()}


# -------------------------------------------------------------- HBM estimates


def forward_tacotron_param_bytes(config: Dict[str, Any],
                                 dtype_bytes: int = 2) -> float:
    """Parameter bytes (GEMM weights only; biases/norm params are noise)."""
    m = config['forward_tacotron']['model']
    n_mels = config['dsp']['num_mels']
    emb, semb, p = m['embed_dims'], m['series_embed_dims'], m['prenet_dims']

    def sp(conv, rnn):
        return (5 * semb * conv + 2 * 5 * conv * conv
                + 2 * (conv * 3 * rnn + rnn * 3 * rnn) + 2 * rnn)

    def cbhg(K, c, in_dim, proj2):
        return (in_dim * c * (K * (K + 1) // 2) + 3 * K * c * c
                + 3 * c * proj2 + proj2 * c + 8 * c * c
                + 2 * (c * 3 * c + c * 3 * c))

    params = (135 * emb + 3 * 135 * semb
              + sp(m['durpred_conv_dims'], m['durpred_rnn_dims'])
              + sp(m['pitch_conv_dims'], m['pitch_rnn_dims'])
              + sp(m['energy_conv_dims'], m['energy_rnn_dims'])
              + cbhg(m['prenet_k'], p, emb, emb)
              + 2 * 3 * 2 * p
              + 2 * (2 * p * 4 * m['rnn_dims']
                     + m['rnn_dims'] * 4 * m['rnn_dims'])
              + 2 * m['rnn_dims'] * n_mels
              + cbhg(m['postnet_k'], m['postnet_dims'], n_mels, n_mels)
              + 2 * m['postnet_dims'] * n_mels)
    return float(params * dtype_bytes)


def forward_tacotron_activation_bytes(config: Dict[str, Any], b: int,
                                      n_tokens: int, t_frames: int,
                                      dtype_bytes: int = 2) -> float:
    """Estimated activation HBM traffic for one generate pass: each stage
    boundary's [B, T, C] tensor counted twice (producer write + consumer
    read). Elementwise chains are taken as fused, so only major stage
    boundaries count; the recurrent kernels read x once and write hidden
    states once."""
    m = config['forward_tacotron']['model']
    n_mels = config['dsp']['num_mels']
    p, emb = m['prenet_dims'], m['embed_dims']
    token_channels = (
        emb                              # embedding out
        + 3 * m['durpred_conv_dims']     # series conv stacks (3 predictors,
        + 2 * m['pitch_conv_dims']       # ~2 boundaries each counted lightly)
        + 2 * m['energy_conv_dims']
        + m['prenet_k'] * p + p + emb    # CBHG bank/proj boundaries
        + 2 * p                          # prenet GRU out
    )
    frame_channels = (
        2 * p                            # length-regulated input
        + 2 * m['rnn_dims']              # BiLSTM hidden states
        + n_mels                         # mel
        + m['postnet_k'] * m['postnet_dims'] + m['postnet_dims'] + n_mels
        + 2 * m['postnet_dims']          # postnet GRU out
        + n_mels                         # mel_post
    )
    return float(2 * dtype_bytes
                 * (b * n_tokens * token_channels
                    + b * t_frames * frame_channels))


# ------------------------------------------------------------------- rooflines


def roofline_report(flops: float, bytes_moved: float, elapsed_s: float,
                    spec: Optional[ChipSpec] = None,
                    dtype: str = 'bf16') -> Dict[str, float]:
    """MFU / HBM utilization / arithmetic intensity for a measured run, the
    FLOP/s peak (and so ``mfu``, ``ridge_intensity`` and ``bound``) that of
    ``dtype``: 'bf16', 'int8', 'tf32' or 'f32'."""
    if dtype not in _PEAK_FIELDS:
        raise ValueError(f'unknown dtype {dtype!r}: one of '
                         f'{", ".join(_PEAK_FIELDS)}')
    spec = spec or chip_spec()
    peak = getattr(spec, _PEAK_FIELDS[dtype])
    achieved = flops / elapsed_s
    bw = bytes_moved / elapsed_s
    return {
        'chip': spec.name,
        'achieved_tflops': achieved / 1e12,
        'mfu': achieved / peak,
        'achieved_hbm_gbps': bw / 1e9,
        'hbm_util': bw / spec.hbm_gbps,
        'arithmetic_intensity': flops / max(bytes_moved, 1.0),
        'ridge_intensity': peak / spec.hbm_gbps,
        'bound': 'compute' if flops / max(bytes_moved, 1.0)
                 > peak / spec.hbm_gbps else 'hbm',
    }
