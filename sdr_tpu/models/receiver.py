"""The FM broadcast receiver: one pure, jittable `step(state, iq_block)`.

Device-first architecture (SURVEY §7 design stance): the reference's 3-thread
pipeline + bounded queue (src/project.cpp:17-271) dissolves into a single
pure function over one block — channelize -> FM demod -> mono/stereo/RDS —
jitted once and scanned over blocks (`lax.scan`) for offline processing, or
driven block-at-a-time for live streaming.  Independent RF channels batch
over a leading axis (vmap-free: every op is batch-polymorphic) and shard
over a device mesh (sdr_tpu.parallel).

Signal chain per block (reference call stack SURVEY §3.1):
  u8 IQ --decode--> I,Q --LPF 100k + decim--> IF --discriminator--> fm_demod
    mono:   fm_demod --U/D resample LPF 16k--> audio            (project.cpp:146)
    stereo: fm_demod --BPF 22-54k--> L-R DSB --mixer(PLL 19k x2)-->
            --U/D resample LPF 16k--> stereo;  L/R matrix w/ delayed mono
                                                          (project.cpp:150-175)
    rds:    fm_demod --BPF 54-60k--> channel --(square, BPF 113.5-114.5k,
            PLL 114k scale .5)--> 57k carrier --mixer--> baseband
            --LPF 3k + U/D resample--> SPS*2375 --RRC--> soft waveform
                                      (project.cpp:200-271 + spec pp.13-14)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from sdr_tpu.config import ModeConfig, get_mode
from sdr_tpu.ops import firdes
from sdr_tpu.ops.demod import fm_arctan, fm_discriminator
from sdr_tpu.ops.pll import pll, pll_init
from sdr_tpu.ops.pointwise import delay_line, lr_matrix, mixer
from sdr_tpu.ops.resample import PolyphaseResampler
from sdr_tpu.io.stream import decode_u8_iq
from sdr_tpu.models.state import (FrontEndState, MonoState, RdsState,
                                  ReceiverState, StereoState)


class Receiver:
    """Configured receiver for one operating mode.

    Args:
      mode: 0-3 (sdr_tpu.config.MODES) or a custom ModeConfig.
      stereo: decode the stereo subcarrier (else mono only).
      rds: decode the RDS subcarrier to RRC-filtered soft waveform
           (requires a mode with rds_sps).
      compat_shared_audio_state: reproduce the reference defect of sharing
           one resampler tail between the mono and stereo audio filters
           (src/project.cpp:146,172) for bit-parity experiments.
      pll_wrap_phase: carry the pilot/RDS PLL phase modulo its period
           (improvement over reference; see ops/pll.py).
      rds_pll_bandwidth: loop bandwidth for the 57 kHz carrier PLL (the
           reference used 0.01 at src/project.cpp:257; narrower tracks the
           squared carrier with less phase noise).
      emit_if: include the demodulated IF in outputs (PSD dumps,
           fm_demod_*.bin-style cross-checks).
      pll_impl: 'scan' (bit-faithful) | 'chunked' (16x vectorized) | 'ff'
           (feedforward carrier recovery — fully vectorized, zero
           sequential scan, the fastest engine); 'auto' = scan.
      demod: 'discriminator' (C++ FMDemod) | 'arctan' (Python model).
      fused_frontend: False = the plain XLA front end (decode, two
           polyphase FIRs, discriminator — the reference path); True = the
           fused GPU kernel (ops/pallas/frontend_kernel.py: u8 decode, FIR,
           decimation and discriminator in one pass, f32 throughout).  The
           kernel always fuses the discriminator, so it requires
           demod='discriminator'.
      conv_engine: 'conv' (XLA conv_general_dilated) | 'tiled' (tiled
           banded GEMM, ops/banded.py — the same terms as dense matmuls;
           float-tolerance equivalent).
      filter_engine: 'direct' (polyphase conv) | 'fft' (overlap-save,
           incl. the U>1 rational stages of modes 2/3 via spectral
           replication) — the two interchangeable convolution engines.
      conv_dtype: 'f32' (exact) | 'bf16' — compute every FIR stage in
           bfloat16 with f32 accumulation (~45-50 dB per-conv SNR,
           transparent under FM demod's ~25 dB floor).
      stereo_phase_adjust: radians added to the recovered 38 kHz carrier
           phase (captures with non-cosine pilot/subcarrier conventions).
    """

    def __init__(self, mode: int | ModeConfig = 0, *, stereo: bool = False,
                 rds: bool = False, compat_shared_audio_state: bool = False,
                 pll_wrap_phase: bool = True,
                 rds_pll_bandwidth: float = 0.003,
                 rds_rrc_taps: int = 151,
                 emit_if: bool = False,
                 pll_impl: str = "auto",
                 pll_chunk: int = 16,
                 pll_window: int = 256,
                 demod: str = "discriminator",
                 fused_frontend: bool = False,
                 filter_engine: str = "direct",
                 conv_engine: str = "conv",
                 conv_dtype: str = "f32",
                 stereo_phase_adjust: float = 0.0,
                 compat_pll: bool = False,
                 deemphasis_us: float | None = None,
                 emit_rssi: bool = False):
        cfg = get_mode(mode) if isinstance(mode, int) else mode
        if rds and cfg.rds_sps is None:
            raise ValueError(f"mode {cfg.mode} does not support RDS")
        self.cfg = cfg
        self.stereo = stereo
        self.rds = rds
        self.compat_shared_audio_state = compat_shared_audio_state
        self.pll_wrap_phase = pll_wrap_phase
        self.rds_pll_bandwidth = rds_pll_bandwidth
        self.emit_if = emit_if
        # per-block RSSI (dBFS of the channelized IF envelope) for signal
        # metering / squelch decisions
        self.emit_rssi = emit_rssi
        if pll_impl == "auto":
            # 'scan' is the bit-level-faithful engine and the default.
            # 'chunked' (ops/pll.py pll_chunked) vectorizes the phase
            # detector over 16-sample chunks (~1.5deg extra phase ripple,
            # behaviorally validated) — select explicitly for PLL-bound
            # stereo/RDS workloads.
            pll_impl = "scan"
        assert pll_impl in ("scan", "chunked", "ff"), pll_impl
        self.pll_impl = pll_impl
        # chunk length for pll_impl='chunked': phase-detector vectorization
        # factor; frozen-feedback error grows O((chunk*bw)^2)
        self.pll_chunk = pll_chunk
        # coherent-integration window (IF samples) for pll_impl='ff' — the
        # fully vectorized feedforward carrier-recovery engine
        # (ops/pll.py pll_feedforward)
        self.pll_window = pll_window
        # 'discriminator' = reference C++ FMDemod (src/filter.cpp:106-133);
        # 'arctan' = the Python golden model's atan2+unwrap+diff demod
        # (model/fmSupportLib.py:34-63)
        assert demod in ("discriminator", "arctan")
        self.demod = demod
        # 'direct' = polyphase filter-bank conv; 'fft' = frequency-
        # domain overlap-save (ops/fft_conv.py) for the decimate-only stages
        # — the two interchangeable convolution engines of the north star.
        assert filter_engine in ("direct", "fft")
        self.filter_engine = filter_engine
        # schedule for the direct engine's resampling FIRs: 'conv' = XLA
        # conv_general_dilated (exact reference reduction order); 'tiled' =
        # tiled banded GEMM (ops/banded.py) — the same terms as dense
        # matmuls (float-tolerance equivalent)
        assert conv_engine in ("conv", "tiled")
        self.conv_engine = conv_engine
        # bf16 compute for every post-demod FIR stage (f32 accumulation):
        # ~45-50 dB per-conv SNR, well under FM demod's ~25 dB distortion
        # floor (fast profile)
        assert conv_dtype in ("f32", "bf16")
        self.conv_dtype = conv_dtype
        _cdt = jnp.bfloat16 if conv_dtype == "bf16" else jnp.float32
        # trim for the recovered 38 kHz subcarrier phase: the loop locks the
        # NCO to the pilot's cosine phase (see ops/pll.py analysis); captures
        # using a different pilot/subcarrier phase convention can be
        # compensated here (radians at 38 kHz; reference passes 0,
        # src/project.cpp:166)
        self.stereo_phase_adjust = stereo_phase_adjust
        # bit-faithful PLL mode: reference trigOffset counter + one-sample
        # NCO lead (both reference defects; for parity experiments)
        self.compat_pll = compat_pll
        if compat_pll:
            self.pll_wrap_phase = False
        # optional FM de-emphasis (75 us Americas / 50 us Europe) applied to
        # the audio outputs; the reference omits it (production extension)
        self.deemph_alpha = None
        if deemphasis_us is not None:
            from sdr_tpu.ops.iir import deemphasis_alpha
            self.deemph_alpha = deemphasis_alpha(cfg.audio_fs, deemphasis_us)

        def _dec_filter(coeff, down=1, up=1):
            """Resampling FIR in the selected engine."""
            if filter_engine == "fft":
                from sdr_tpu.ops.fft_conv import OverlapSaveFIR
                return OverlapSaveFIR(coeff, down, up)
            if conv_engine == "tiled":
                from sdr_tpu.ops.banded import TiledBandedFIR
                return TiledBandedFIR(coeff, up, down, compute_dtype=_cdt)
            return PolyphaseResampler(coeff, up, down, compute_dtype=_cdt)

        if_fs = cfg.if_fs
        # --- filter design (once, host-side; reference project.cpp:37,97,104,117)
        rf_coeff = firdes.lowpass(cfg.rf_fs, cfg.rf_fc, cfg.rf_taps, 1)
        audio_coeff = firdes.lowpass(if_fs * cfg.audio_interp, cfg.audio_fc,
                                     cfg.audio_taps, cfg.audio_gain)
        self.rf_resampler = _dec_filter(rf_coeff, cfg.rf_decim)
        # fused u8-decode + channelize + discriminator GPU kernel
        # (ops/pallas/frontend_kernel.py): the f32 I/Q stream never exists
        self.fused_frontend = bool(fused_frontend)
        if self.fused_frontend and demod != "discriminator":
            raise ValueError("fused_frontend fuses the discriminator; "
                             "demod='arctan' needs fused_frontend=False")
        # the fm stream is stored at bf16 when every direct-engine FIR that
        # reads it computes in bf16 anyway (the store rounds only where the
        # compute rounds regardless) — halves its HBM traffic
        self._mat_bf16 = (self.fused_frontend and conv_dtype == "bf16"
                          and filter_engine == "direct")
        if self.fused_frontend:
            from sdr_tpu.ops.pallas.frontend_kernel import FusedFrontend
            self._fused_fe = FusedFrontend(
                rf_coeff, cfg.rf_decim,
                out_dtype=jnp.bfloat16 if self._mat_bf16 else None)
        self.audio_resampler = _dec_filter(audio_coeff, cfg.audio_decim,
                                           cfg.audio_interp)
        # one conv for ALL the IF band-pass stages reading fm_demod: stereo
        # channel 22-54k + pilot 18.5-19.5k + RDS channel 54-60k share the
        # input stream and tail semantics (reference runs them as separate
        # resample calls, src/project.cpp:162-165,245) — fusing them means
        # fm_demod is read once instead of three times
        self.if_bpf3 = None
        if stereo:
            chan_coeff = firdes.bandpass(if_fs, cfg.stereo_lo, cfg.stereo_hi,
                                         cfg.bp_taps)
            pilot_coeff = firdes.bandpass(if_fs, cfg.pilot_lo, cfg.pilot_hi,
                                          cfg.bp_taps)
            if filter_engine == "direct" and rds:
                from sdr_tpu.ops.resample import MultiFIR
                rds_chan3 = firdes.bandpass(if_fs, cfg.rds_lo, cfg.rds_hi,
                                            cfg.bp_taps)
                self.if_bpf3 = MultiFIR([chan_coeff, pilot_coeff, rds_chan3],
                                        compute_dtype=_cdt)
                self.stereo_bpf = None
                self.channel_filter = self.carrier_filter = None
            elif filter_engine == "direct":
                # one conv, two output channels: channel + pilot BPFs share
                # the input stream and tail (ops/resample.py MultiFIR)
                from sdr_tpu.ops.resample import MultiFIR
                self.stereo_bpf = MultiFIR([chan_coeff, pilot_coeff],
                                           compute_dtype=_cdt)
                self.channel_filter = self.carrier_filter = None
            else:
                self.stereo_bpf = None
                self.channel_filter = _dec_filter(chan_coeff)
                self.carrier_filter = _dec_filter(pilot_coeff)
            self.stereo_audio_resampler = _dec_filter(
                audio_coeff, cfg.audio_decim, cfg.audio_interp)
        if rds:
            u, d = cfg.rds_resample
            self.rds_u, self.rds_d = u, d
            rds_chan = firdes.bandpass(if_fs, cfg.rds_lo, cfg.rds_hi, cfg.bp_taps)
            rds_carr = firdes.bandpass(if_fs, cfg.rds_carrier_lo,
                                       cfg.rds_carrier_hi, cfg.bp_taps)
            rds_lpf = firdes.lowpass(if_fs * u, cfg.rds_fc, cfg.bp_taps * u, u)
            rrc = firdes.root_raised_cosine(cfg.rds_fs, rds_rrc_taps,
                                            cfg.rds_symbol_rate)
            self.rds_channel_filter = (None if self.if_bpf3 is not None
                                       else _dec_filter(rds_chan))
            self.rds_carrier_filter = _dec_filter(rds_carr)
            if conv_engine == "tiled":
                from sdr_tpu.ops.banded import TiledBandedFIR
                self.rds_resampler = TiledBandedFIR(rds_lpf, u, d,
                                                    compute_dtype=_cdt)
            else:
                self.rds_resampler = PolyphaseResampler(rds_lpf, u, d,
                                                        compute_dtype=_cdt)
            self.rds_rrc = _dec_filter(rrc)
            # group-delay alignment of the channel path against the
            # square->BPF(51 taps)->PLL carrier path (spec Fig 10 all-pass)
            self.rds_delay = (cfg.bp_taps - 1) // 2
            # IF samples per block must make symbols integral:
            # need d | n_if and sps | n_if*u/d.
            g = np.gcd(cfg.rds_sps, u)
            self.rds_if_align = d * cfg.rds_sps // g

    # ------------------------------------------------------------------ state
    def init_state(self, batch_shape: tuple[int, ...] = ()) -> ReceiverState:
        f32 = jnp.float32
        if self.fused_frontend:
            # the fused kernel carries the raw u8 tail (value 128 == 0.0)
            front = FrontEndState(
                i_tail=self._fused_fe.init_state(batch_shape),
                q_tail=jnp.zeros(batch_shape + (0,), f32),
                prev_i=jnp.zeros(batch_shape, f32),
                prev_q=jnp.zeros(batch_shape, f32),
            )
        else:
            front = FrontEndState(
                i_tail=self.rf_resampler.init_state(batch_shape),
                q_tail=self.rf_resampler.init_state(batch_shape),
                prev_i=jnp.zeros(batch_shape, f32),
                prev_q=jnp.zeros(batch_shape, f32),
            )
        mono = MonoState(
            audio_tail=self.audio_resampler.init_state(batch_shape),
            deemph=jnp.zeros(batch_shape, f32))
        stereo = None
        if self.stereo:
            if self.if_bpf3 is not None:
                # fused 3-filter conv: the single shared tail lives here;
                # RdsState.channel_tail is empty (see below)
                ch_tail = self.if_bpf3.init_state(batch_shape)
                ca_tail = jnp.zeros(batch_shape + (0,), f32)
            elif self.stereo_bpf is not None:
                ch_tail = self.stereo_bpf.init_state(batch_shape)
                ca_tail = jnp.zeros(batch_shape + (0,), f32)
            else:
                ch_tail = self.channel_filter.init_state(batch_shape)
                ca_tail = self.carrier_filter.init_state(batch_shape)
            stereo = StereoState(
                channel_tail=ch_tail,
                carrier_tail=ca_tail,
                pll=pll_init(batch_shape),
                mono_delay=jnp.zeros(batch_shape + (self.cfg.mono_delay,), f32),
                stereo_audio_tail=self.stereo_audio_resampler.init_state(
                    batch_shape),
                deemph_l=jnp.zeros(batch_shape, f32),
                deemph_r=jnp.zeros(batch_shape, f32),
            )
        rds = None
        if self.rds:
            rds = RdsState(
                channel_tail=(jnp.zeros(batch_shape + (0,), f32)
                              if self.if_bpf3 is not None else
                              self.rds_channel_filter.init_state(batch_shape)),
                carrier_tail=self.rds_carrier_filter.init_state(batch_shape),
                pll=pll_init(batch_shape),
                delay=jnp.zeros(batch_shape + (self.rds_delay,), f32),
                lpf_resamp_tail=self.rds_resampler.init_state(batch_shape),
                rrc_tail=self.rds_rrc.init_state(batch_shape),
            )
        return ReceiverState(front=front, mono=mono, stereo=stereo, rds=rds)

    def _pll(self, x, st, **kw):
        """Dispatch to the selected PLL engine."""
        with jax.named_scope(f"pll_{self.pll_impl}"):
            return self._pll_inner(x, st, **kw)

    def _pll_inner(self, x, st, **kw):
        if self.compat_pll:
            return pll(x, st, wrap_phase=False, lag_correction=False, **kw)
        if self.pll_impl == "chunked":
            from sdr_tpu.ops.pll import pll_chunked
            return pll_chunked(x, st, chunk=self.pll_chunk, **kw)
        if self.pll_impl == "ff":
            from sdr_tpu.ops.pll import pll_feedforward
            return pll_feedforward(x, st, window=self.pll_window, **kw)
        return pll(x, st, wrap_phase=self.pll_wrap_phase, **kw)

    # ------------------------------------------------------------------- step
    def step(self, state: ReceiverState, iq_u8: jax.Array
             ) -> tuple[ReceiverState, dict[str, jax.Array]]:
        """Process one u8 IQ block (..., block) -> (new_state, outputs).

        Outputs: 'mono' always; 'left'/'right' when stereo; 'rds_soft' (RRC
        output at SPS*2375) when rds.  Pure function — safe to jit/scan/shard.
        """
        cfg = self.cfg
        # named scopes surface per-stage costs in jax.profiler traces —
        # the equivalent of the reference's per-building-block timing
        # requirement (SURVEY §5.1)
        with jax.named_scope("rf_frontend"):
            if self.fused_frontend:
                fm_demod, i_tail, prev_i, prev_q, psum = self._fused_fe(
                    iq_u8, state.front.i_tail, state.front.prev_i,
                    state.front.prev_q)
                front = FrontEndState(i_tail, state.front.q_tail,
                                      prev_i, prev_q)
                rssi_power = (psum / fm_demod.shape[-1]
                              if self.emit_rssi else None)
                return self._post_demod(state, fm_demod, front, rssi_power)
            i_raw, q_raw = decode_u8_iq(iq_u8)
            # RF front end (reference rf_thread, src/project.cpp:48-69)
            i_ds, i_tail = self.rf_resampler(i_raw, state.front.i_tail)
            q_ds, q_tail = self.rf_resampler(q_raw, state.front.q_tail)
        return self._finish_step(state, i_ds, q_ds, i_tail, q_tail)

    def step_iq(self, state: ReceiverState, i_raw: jax.Array,
                q_raw: jax.Array
                ) -> tuple[ReceiverState, dict[str, jax.Array]]:
        """Like step() but on already-decoded float I/Q at the RF rate —
        the entry point for channelized wideband front-ends
        (ops/channelizer.py), which deliver complex baseband directly."""
        with jax.named_scope("rf_frontend"):
            i_ds, i_tail = self.rf_resampler(i_raw, state.front.i_tail)
            q_ds, q_tail = self.rf_resampler(q_raw, state.front.q_tail)
        return self._finish_step(state, i_ds, q_ds, i_tail, q_tail)

    def _finish_step(self, state, i_ds, q_ds, i_tail, q_tail):
        with jax.named_scope("demod"):
            if self.demod == "arctan":
                # prev_i slot carries the phase; prev_q is unused
                fm_demod, prev_phase = fm_arctan(i_ds, q_ds,
                                                 state.front.prev_i)
                front = FrontEndState(i_tail, q_tail, prev_phase,
                                      state.front.prev_q)
            else:
                fm_demod, prev_i, prev_q = fm_discriminator(
                    i_ds, q_ds, state.front.prev_i, state.front.prev_q)
                front = FrontEndState(i_tail, q_tail, prev_i, prev_q)
        rssi_power = (jnp.mean(i_ds * i_ds + q_ds * q_ds, axis=-1)
                      if self.emit_rssi else None)
        return self._post_demod(state, fm_demod, front, rssi_power)

    def _post_demod(self, state, fm_demod, front, rssi_power):
        """Everything downstream of the discriminator: mono / stereo / RDS."""
        cfg = self.cfg
        outputs: dict[str, jax.Array] = {}
        if rssi_power is not None:
            outputs["rssi_db"] = 10.0 * jnp.log10(rssi_power + 1e-12)
        if self.emit_if:
            # demodulated-IF tap for PSD dumps / fm_demod_*.bin-style
            # cross-checks (reference model/fmMonoBlock.py:277-280)
            outputs["fm_demod"] = fm_demod

        # Mono path (reference src/project.cpp:146).  In stereo mode with
        # the direct engine the mono resample is deferred and BATCHED with
        # the stereo (L-R) resample below — both run the same audio filter
        # bank, so stacking them on the conv batch axis halves the conv
        # launches (bit-identical: conv rows are independent).
        from sdr_tpu.ops.banded import TiledBandedFIR
        defer_mono = (self.stereo and not self.compat_shared_audio_state
                      and isinstance(self.audio_resampler,
                                     (PolyphaseResampler, TiledBandedFIR)))
        mono_audio = audio_tail = None
        if not defer_mono:
            with jax.named_scope("mono_path"):
                mono_audio, audio_tail = self.audio_resampler(
                    fm_demod, state.mono.audio_tail)
        deemph_state = state.mono.deemph
        if self.deemph_alpha is not None and not self.stereo:
            from sdr_tpu.ops.iir import first_order_iir
            mono_out, deemph_state = first_order_iir(
                mono_audio, deemph_state, alpha=self.deemph_alpha)
            outputs["mono"] = mono_out
        elif not defer_mono:
            outputs["mono"] = mono_audio

        # --- IF band-pass extraction (fused into one conv where possible)
        rds_channel = None
        if self.stereo:
            st = state.stereo
            # L-R DSB extraction + pilot isolation (project.cpp:162-165)
            if self.if_bpf3 is not None:
                # stereo channel + pilot + RDS channel: ONE conv, one tail
                (channel, pilot, rds_channel), channel_tail = self.if_bpf3(
                    fm_demod, st.channel_tail)
                carrier_tail = st.carrier_tail
                rds_channel_tail = state.rds.channel_tail  # empty
            elif self.stereo_bpf is not None:
                (channel, pilot), channel_tail = self.stereo_bpf(
                    fm_demod, st.channel_tail)
                carrier_tail = st.carrier_tail
            else:
                channel, channel_tail = self.channel_filter(fm_demod,
                                                            st.channel_tail)
                pilot, carrier_tail = self.carrier_filter(fm_demod,
                                                          st.carrier_tail)
        if self.rds:
            rs = state.rds
            if rds_channel is None:
                # channel extraction 54-60 kHz (reference src/project.cpp:245)
                rds_channel, rds_channel_tail = self.rds_channel_filter(
                    fm_demod, rs.channel_tail)
            # squaring nonlinearity -> 114 kHz line (project.cpp:248-252)
            squared = rds_channel * rds_channel
            rds_carrier_in, rds_carrier_tail = self.rds_carrier_filter(
                squared, rs.carrier_tail)

        # --- carrier recovery
        if (self.stereo and self.rds and self.pll_impl == "ff"
                and not self.compat_pll):
            # both carriers through ONE fused feedforward program (stacked
            # engine axis; numerically equivalent to two calls within f32
            # fusion tolerance — see ops/pll.py pll_feedforward_multi)
            with jax.named_scope("carrier_ff_pair"):
                from sdr_tpu.ops.pll import pll_feedforward_multi
                (nco_s, nco_r), (pll_s, pll_r) = pll_feedforward_multi(
                    (pilot, rds_carrier_in), (st.pll, rs.pll),
                    params=((float(cfg.pilot_freq), float(cfg.if_fs), 2.0,
                             float(self.stereo_phase_adjust)),
                            (float(cfg.rds_carrier_freq), float(cfg.if_fs),
                             0.5, 0.0)),
                    window=self.pll_window)
        else:
            if self.stereo:
                nco_s, pll_s = self._pll(pilot, st.pll, freq=cfg.pilot_freq,
                                         fs=cfg.if_fs, nco_scale=2.0,
                                         phase_adjust=self.stereo_phase_adjust,
                                         norm_bandwidth=0.01)
            if self.rds:
                nco_r, pll_r = self._pll(rds_carrier_in, rs.pll,
                                         freq=cfg.rds_carrier_freq,
                                         fs=cfg.if_fs, nco_scale=0.5,
                                         norm_bandwidth=self.rds_pll_bandwidth)

        stereo_state = state.stereo
        if self.stereo:
            mixed = mixer(channel, nco_s)                  # project.cpp:169
            if self.compat_shared_audio_state:
                # reference defect: stereo resample continues the mono tail
                stereo_audio, audio_tail = self.audio_resampler(mixed, audio_tail)
                stereo_audio_tail = st.stereo_audio_tail
            elif defer_mono:
                # one conv for both IF->audio resamples (same filter bank);
                # in the bf16-materialization profile `mixed` joins the
                # stack at bf16 (the conv rounds it to bf16 regardless)
                with jax.named_scope("audio_resample_pair"):
                    pair, pair_tails = self.audio_resampler(
                        jnp.stack([fm_demod,
                                   mixed.astype(fm_demod.dtype)]),
                        jnp.stack([state.mono.audio_tail,
                                   st.stereo_audio_tail]))
                mono_audio, stereo_audio = pair[0], pair[1]
                audio_tail, stereo_audio_tail = pair_tails[0], pair_tails[1]
                outputs["mono"] = mono_audio
            else:
                stereo_audio, stereo_audio_tail = self.stereo_audio_resampler(
                    mixed, st.stereo_audio_tail)
            # delayed mono against BPF group delay (src/project.cpp:152-159)
            mono_shift, mono_delay = delay_line(mono_audio, st.mono_delay)
            left, right = lr_matrix(mono_shift, stereo_audio)  # project.cpp:175
            deemph_l, deemph_r = st.deemph_l, st.deemph_r
            if self.deemph_alpha is not None:
                from sdr_tpu.ops.iir import first_order_iir
                left, deemph_l = first_order_iir(left, deemph_l,
                                                 alpha=self.deemph_alpha)
                right, deemph_r = first_order_iir(right, deemph_r,
                                                  alpha=self.deemph_alpha)
            outputs["left"] = left
            outputs["right"] = right
            stereo_state = StereoState(channel_tail, carrier_tail, pll_s,
                                       mono_delay, stereo_audio_tail,
                                       deemph_l, deemph_r)

        mono_state = MonoState(audio_tail=audio_tail, deemph=deemph_state)

        rds_state = state.rds
        if self.rds:
            # all-pass delay aligning channel to carrier (src/project.cpp:260-266)
            chan_delayed, delay = delay_line(rds_channel, rs.delay)
            baseband = mixer(nco_r, chan_delayed)          # src/project.cpp:269
            # ---- beyond the reference code: spec pp.13-14 chain ----
            resampled, lpf_tail = self.rds_resampler(baseband,
                                                     rs.lpf_resamp_tail)
            soft, rrc_tail = self.rds_rrc(resampled, rs.rrc_tail)
            outputs["rds_soft"] = soft
            rds_state = RdsState(rds_channel_tail, rds_carrier_tail, pll_r,
                                 delay, lpf_tail, rrc_tail)

        new_state = ReceiverState(front=front, mono=mono_state,
                                  stereo=stereo_state, rds=rds_state)
        return new_state, outputs

    # -------------------------------------------------------------- execution
    def block_align_u8(self) -> int:
        """Minimum valid step size in u8 bytes: every decimation must divide
        cleanly and every filter tail must fit (split-invariance makes any
        multiple of this equivalent, SURVEY §5.7)."""
        align = 2 * self.cfg.rf_decim * self.cfg.audio_decim
        if self.rds:
            align = int(np.lcm(align, 2 * self.cfg.rf_decim * self.rds_if_align))
        if (self.stereo or self.rds) and self.pll_impl == "ff":
            # keep the feedforward engine's coherent-integration window grid
            # block-size independent (it clamps to a divisor otherwise)
            align = int(np.lcm(align, 2 * self.cfg.rf_decim * self.pll_window))
        # largest carried tail: audio resampler needs ceil((taps-1)/U) IF
        # samples per block
        min_if = self.audio_resampler.state_len
        while align // (2 * self.cfg.rf_decim) < min_if:
            align *= 2
        return align

    def block_size_u8(self, blocks_per_step: int = 1) -> int:
        """u8 bytes per step; multiple reference blocks may be fused into one
        jit step (exactness is split-invariant, SURVEY §5.7)."""
        base = int(np.lcm(self.cfg.block_size_u8, self.block_align_u8()))
        return base * blocks_per_step

    @functools.cached_property
    def _jit_step(self):
        return jax.jit(self.step)

    def run(self, iq_u8: np.ndarray | jax.Array, *, blocks_per_step: int = 1,
            state: ReceiverState | None = None,
            unroll: int = 1):
        """Scan the receiver over a whole capture.

        iq_u8: (..., n) u8 stream.  The capture is consumed in bs-sized
        steps, then the remainder is FLUSHED with one extra step at the
        finest aligned granularity (split-invariance makes any block split
        output-identical, SURVEY §5.7) — only a sub-`block_align_u8` tail
        is dropped (reference model behavior, fmMonoBlock.py:216-217).
        Without the flush, engine sets with coarse step alignment (fused
        front-end / IF-bank tiles) silently dropped up to bs-1 bytes —
        ~0.25 s of signal at the fast profile's bps=8 step, which cost the
        round-4 envelope table its "constant 2-group RDS deficit" (a
        truncation artifact, not a warm-up transient).
        Returns (outputs, final_state) with outputs concatenated over time.
        """
        bs = self.block_size_u8(blocks_per_step)
        *lead, n = iq_u8.shape
        align = self.block_align_u8()
        if bs > n:
            # capture shorter than the natural block: fall back to the
            # largest aligned block that fits (same outputs by
            # split-invariance)
            bs = (n // align) * align
            if bs == 0:
                raise ValueError(
                    f"capture of {n} bytes shorter than minimum block "
                    f"{align}")
        nblocks = n // bs
        trimmed = jnp.asarray(iq_u8[..., : nblocks * bs]).reshape(
            *lead, nblocks, bs)
        trimmed = jnp.moveaxis(trimmed, -2, 0)  # (nblocks, ..., bs)
        if state is None:
            state = self.init_state(tuple(lead))

        def scan_fn(st, blk):
            return self.step(st, blk)

        final_state, outs = jax.lax.scan(scan_fn, state, trimmed, unroll=unroll)
        # (nblocks, ..., per_block) -> (..., nblocks*per_block); per-step
        # scalars (e.g. rssi_db) just move their block axis to the end
        outputs = {}
        scalar_keys = set()
        for k, v in outs.items():
            if v.ndim == len(lead) + 1:
                scalar_keys.add(k)
                outputs[k] = jnp.moveaxis(v, 0, -1) if lead else v
            else:
                outputs[k] = jnp.moveaxis(v, 0, -2).reshape(*lead, -1)
        tail_bs = ((n - nblocks * bs) // align) * align
        if tail_bs:
            tail_blk = jnp.asarray(
                iq_u8[..., nblocks * bs: nblocks * bs + tail_bs])
            final_state, tail_out = self._jit_step(final_state, tail_blk)
            for k, v in tail_out.items():
                outputs[k] = jnp.concatenate(
                    [outputs[k], v[..., None] if k in scalar_keys else v],
                    axis=-1)
        return outputs, final_state
