"""Rate control: CRF / ABR / CQP with VBV clipping (x265 analog:
encoder/ratecontrol.cpp — rateControlStart:1245, rateEstimateQscale:1742,
clipQscale:2283, rateControlEnd:2778).

The model is the x264-lineage single-pass controller:
  qscale = blurred_complexity^(1-qcompress) / rate_factor
with
  * CRF: rate_factor is a constant derived from the CRF value and a
    resolution-normalized base complexity (ratecontrol.cpp:1035-1050);
  * ABR: rate_factor = wanted_bits_window / cplxr_sum, both running sums
    updated per coded frame, plus the overflow feedback term with the
    abrBuffer tolerance window (rateEstimateQscale:1960-2050);
  * I/B pictures get the ipFactor/pbFactor qscale ratios (x265 defaults
    1.4 / 1.3);
  * VBV: a satd-based bits predictor clips qscale so the coded-picture
    buffer neither underflows nor overflows (clipQscale/updateVbv).

Frame-ordered contract: start() and end() are called in encode order
(the m_startEndOrder gate, ratecontrol.h:209-221, enforced here simply
because the GOP scheduler is serial).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from x265_tpu_torch.api.params import RC_ABR, RC_CQP, RC_CRF
from x265_tpu_torch.utils.profiling import spanned

I_SLICE, P_SLICE, B_SLICE = 2, 1, 0    # HEVC syntax values


def qp2qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale2qp(qscale: float) -> float:
    return 12.0 + 6.0 * math.log2(qscale / 0.85)


IP_FACTOR = 1.4
PB_FACTOR = 1.3


@dataclass
class _Predictor:
    """bits ~= (coeff * satd + offset) / qscale (x265 Predictor,
    ratecontrol.h:105; updateVbv's damped update)."""
    coeff: float = 1.0
    count: float = 1.0
    decay: float = 0.5
    offset: float = 0.0

    @property
    def value(self) -> float:
        return self.coeff / self.count

    def update(self, bits: float, satd: float, qscale: float) -> None:
        if satd < 1:
            return
        self.coeff = self.coeff * self.decay + bits * qscale / satd
        self.count = self.count * self.decay + 1.0


class RateControl:
    def __init__(self, param):
        p = param
        self.zones = parse_zones(getattr(p, "zones", ""))
        self.mode = p.rc_mode
        self.qp_const = p.qp
        self.lossless = p.lossless
        self.qcompress = getattr(p, "qcompress", 0.6)
        self.ip_factor = getattr(p, "ip_factor", IP_FACTOR)
        self.pb_factor = getattr(p, "pb_factor", PB_FACTOR)
        self.qp_min = getattr(p, "qp_min", 0)
        self.qp_max = getattr(p, "qp_max", 51)
        self.fps = p.fps_num / max(1, p.fps_den)
        self.bitrate = p.bitrate * 1000.0      # kbps -> bps
        self.tolerance = 1.0
        ncu = ((p.width + 15) // 16) * ((p.height + 15) // 16)
        base_cplx = ncu * (120 if p.bframes else 80)
        self.crf_constant = (base_cplx ** (1 - self.qcompress) /
                            qp2qscale(p.crf))
        # --crf-min/--crf-max: per-frame qscale clamps via the same
        # constant construction (x265 rfConstantMin/Max)
        crf_min = getattr(p, "crf_min", 0.0)
        crf_max = getattr(p, "crf_max", 0.0)
        self.crf_constant_min = (base_cplx ** (1 - self.qcompress) /
                                 qp2qscale(crf_min)) if crf_min > 0 else 0.0
        self.crf_constant_max = (base_cplx ** (1 - self.qcompress) /
                                 qp2qscale(crf_max)) if crf_max > 0 else 0.0
        self.qpstep = max(1, int(getattr(p, "qpstep", 4)))
        self.strict_cbr = bool(getattr(p, "strict_cbr", False))
        # ABR state (x264 ratecontrol_init values)
        self.cplxr_sum = 0.01 * (7.0e5 ** self.qcompress) * (ncu ** 0.5)
        self.wanted_bits_window = max(1.0, self.bitrate / self.fps)
        self.total_bits = 0.0
        self.frames_coded = 0
        # blurred complexity (short-term decay)
        self.short_cplx_sum = 0.0
        self.short_cplx_count = 0.0
        self.last_qscale = qp2qscale(p.qp)
        # VBV
        self.vbv_bufsize = p.vbv_bufsize * 1000.0
        self.vbv_maxrate = p.vbv_maxrate * 1000.0
        self.vbv = self.vbv_bufsize > 0 and self.vbv_maxrate > 0
        vbv_init = float(getattr(p, "vbv_init", 0.9))
        if vbv_init > 1.0:       # absolute kbits form (x265 accepts both)
            vbv_init = min(1.0, vbv_init * 1000.0 / max(1.0,
                                                        self.vbv_bufsize))
        self.buffer_fill = self.vbv_bufsize * max(0.0, vbv_init)
        self.buffer_rate = self.vbv_maxrate / self.fps if self.vbv else 0.0
        self.pred = {I_SLICE: _Predictor(coeff=0.3),
                     P_SLICE: _Predictor(coeff=0.2),
                     B_SLICE: _Predictor(coeff=0.15)}
        self._pending = None
        self.band_grad_pending = 0
        # --- two-pass (x265 --pass; initPass2 ratecontrol.cpp:994) ---
        self.pass_num = p.pass_num
        self.stats_file = p.stats_file
        self.pass1_records = []
        self.pass2_qp = None
        self.pass2_qs = None
        self.pass2_cum = None
        self.pass2_idx = 0
        if self.pass_num == 2:
            self._init_pass2()

    def _init_pass2(self):
        """Per-frame qscale plan from the pass-1 stats (x265 initPass2,
        ratecontrol.cpp:994). The complexity signal is the MEASURED
        coding complexity cplx_i = bits1_i * qscale1_i (q-invariant
        under the linear bits model — better than the lowres satd the
        closed form used before), allocated as q_i = cplx_i^(1-qcomp)
        * m_i / RF with RF solved so the predicted total hits target.
        Execution is CLOSED-LOOP: start() scales each planned qscale by
        the running (actual - planned) overflow, so model error cannot
        accumulate into a 30-40%% miss (x264 2-pass overflow
        compensation; the old open-loop plan did exactly that)."""
        import json
        with open(self.stats_file) as f:
            recs = [json.loads(line) for line in f if line.strip()]
        if not recs:
            return
        n = len(recs)
        target_total = self.bitrate / self.fps * n
        cplx = []
        rceqs = []
        for rec in recs:
            c = max(1.0, rec["bits"] * rec["qscale"])
            cplx.append(c)
            # undo slice-type modulation so RF applies uniformly
            m = (1 / self.ip_factor if rec["type"] == "I"
                 else (PB_FACTOR if rec["type"] == "B" else 1.0))
            rceqs.append(c ** (1 - self.qcompress) * m)
        rf = target_total / max(1e-9, sum(c / r for c, r in
                                          zip(cplx, rceqs)))
        self.pass2_qs = [r / max(1e-9, rf) for r in rceqs]
        # pass-1 cuTree offset maps ride the stats file so pass 2 reuses
        # them instead of recomputing (x265 cuTree stat files,
        # ratecontrol.h:237-252)
        self.pass2_cutree = [rec.get("cutree") for rec in recs]
        if self.vbv:
            self._pass2_vbv_replan(cplx)
        planned = [c / q for c, q in zip(cplx, self.pass2_qs)]
        # cumulative planned bits BEFORE each frame (overflow reference)
        self.pass2_cum = [0.0]
        for b in planned[:-1]:
            self.pass2_cum.append(self.pass2_cum[-1] + b)
        self.pass2_qp = True          # flag: plan available

    def _pass2_vbv_replan(self, cplx):
        """VBV re-plan over the pass-2 qscale schedule (x265 initPass2 ->
        vbv2Pass, x264 findUnderflow/fixUnderflow analog): simulate the
        CPB over the plan's predicted bits (cplx_i / q_i); wherever it
        would underflow, raise the qscales of the whole deficit stretch
        and re-simulate until the plan is feasible."""
        floor_ = 0.15 * self.vbv_bufsize
        qs = self.pass2_qs
        for _ in range(64):
            fill = self.vbv_bufsize * 0.9
            start = 0                   # beginning of the deficit stretch
            bad = -1
            for i, (c, q) in enumerate(zip(cplx, qs)):
                if fill >= 0.7 * self.vbv_bufsize:
                    start = i           # buffer healthy here
                fill = min(self.vbv_bufsize, fill + self.buffer_rate)
                fill -= c / q
                if fill < floor_:
                    bad = i
                    break
            if bad < 0:
                return
            for j in range(start, bad + 1):   # fixUnderflow: spend less
                qs[j] *= 1.1

    def write_stats(self) -> None:
        """Flush pass-1 per-frame records (x265 rateControlEnd's
        writeRateControlFrameStats analog)."""
        if self.pass_num != 1:
            return
        import json
        with open(self.stats_file, "w") as f:
            for rec in self.pass1_records:
                f.write(json.dumps(rec) + "\n")

    # ---- per-frame API (encode order) ----

    def zone_for(self, frame_idx=None):
        """The zone covering frame_idx (encode-order count if None), or
        None (x265 Encoder::getZone / x264 zone lookup analog)."""
        idx = self.frames_coded if frame_idx is None else frame_idx
        for z in reversed(self.zones):     # later zones win (x264 rule)
            if z["start"] <= idx <= z["end"]:
                return z
        return None

    @spanned("ratecontrol")
    def start_forced(self, slice_type: int, qp: int,
                     satd_cost: float) -> int:
        """--qpfile forced-QP frame: no RC decision is made, but the
        ABR/VBV models must still see the real operating point — else
        end() falls back to last_qscale and the bits predictor / buffer
        model drift whenever forced QPs differ from RC's own choice."""
        qp = max(self.qp_min, min(self.qp_max, int(qp)))
        qscale = qp2qscale(qp)
        rceq = max(1.0, satd_cost) ** (1 - self.qcompress)
        self._pending = (slice_type, satd_cost, qscale, rceq)
        self.last_qscale = qscale
        return qp

    @spanned("ratecontrol")
    def start(self, slice_type: int, satd_cost: float,
              frame_idx=None) -> int:
        """Pick the slice QP for the next frame in encode order."""
        self.band_grad_pending = 0    # any unconsumed emergency gradient
        zone = self.zone_for(frame_idx)
        if zone is not None and "q" in zone:
            qp = max(0, min(51, zone["q"]))
            self._pending = (slice_type, satd_cost, qp2qscale(qp))
            self.last_qscale = qp2qscale(qp)
            return qp
        if self.pass2_qp is not None and self.pass2_idx < len(self.pass2_qs):
            idx = self.pass2_idx
            self.pass2_idx += 1
            qscale = self.pass2_qs[idx]
            # systematic-model-bias correction: the linear bits model
            # (bits ~ cplx/q) under-predicts by a roughly constant
            # factor; measure actual/planned over the coded prefix and
            # scale the remaining plan immediately (x264's 2-pass
            # rate_factor retuning) — the additive overflow term below
            # only catches up late in short encodes
            if idx >= 4 and self.pass2_cum[idx] > 0:
                bias = self.total_bits / self.pass2_cum[idx]
                qscale *= min(1.5, max(0.67, bias))
            # closed-loop overflow compensation: compare actual coded
            # bits against the plan's cumulative total and correct the
            # remaining frames (x264 2-pass abr buffer; bounded step)
            buf = max(1.0, 0.5 * self.bitrate)     # half a second of bits
            overflow = 1.0 + (self.total_bits - self.pass2_cum[idx]) / buf
            qscale *= min(1.6, max(0.6, overflow))
            qscale = self._clip_vbv(slice_type, satd_cost, qscale)
            qp = max(0, min(51, int(round(qscale2qp(qscale)))))
            self._pending = (slice_type, satd_cost, qp2qscale(qp))
            self.last_qscale = qp2qscale(qp)
            return qp
        if self.mode == RC_CQP:
            qp = self.qp_const
            if not self.lossless:
                qp += (-3 if slice_type == I_SLICE else
                       (3 if slice_type == B_SLICE else 0))
            self._pending = (slice_type, satd_cost, qp2qscale(qp))
            return max(0, min(51, qp))

        # blurred complexity
        self.short_cplx_sum *= 0.5
        self.short_cplx_count *= 0.5
        self.short_cplx_sum += satd_cost
        self.short_cplx_count += 1
        blurred = self.short_cplx_sum / self.short_cplx_count
        rceq = blurred ** (1 - self.qcompress)

        if self.mode == RC_CRF:
            qscale = rceq / self.crf_constant
        else:  # ABR
            rate_factor = self.wanted_bits_window / self.cplxr_sum
            qscale = rceq / rate_factor
            # overflow compensation (--strict-cbr halves the tolerance
            # window and forbids undershoot relief, x265
            # rateEstimateQscale's bStrictCbr branch)
            wanted = (self.bitrate / self.fps) * (self.frames_coded + 1)
            abr_buffer = 2 * self.tolerance * self.bitrate
            if self.strict_cbr:
                abr_buffer *= 0.5
            overflow = 1.0 + (self.total_bits - wanted) / max(1.0, abr_buffer)
            if self.strict_cbr:
                overflow = max(overflow, 1.0)
            qscale *= min(2.0, max(0.5, overflow))

        if zone is not None and "b" in zone:
            qscale /= zone["b"]            # bitrate multiplier (x264 rule)
        # slice-type modulation (applied in qscale domain)
        if slice_type == I_SLICE:
            qscale /= self.ip_factor
        elif slice_type == B_SLICE:
            qscale *= self.pb_factor

        # temporal smoothing: limit step vs last frame (x264 lstep;
        # --qpstep)
        lstep = 2.0 ** (self.qpstep / 6.0)
        if self.frames_coded > 0 and slice_type != I_SLICE:
            qscale = min(max(qscale, self.last_qscale / lstep),
                         self.last_qscale * lstep)

        # --crf-min/--crf-max: rate-factor clamps applied after the
        # type/step modifiers (x265 rfConstantMin/Max semantics — the
        # band bounds how far modifiers may move qscale off the CRF
        # curve at this frame's complexity)
        if self.mode == RC_CRF:
            if self.crf_constant_min > 0:
                qscale = max(qscale, rceq / self.crf_constant_min)
            if self.crf_constant_max > 0:
                qscale = min(qscale, rceq / self.crf_constant_max)

        qscale = self._clip_vbv(slice_type, satd_cost, qscale)
        self.last_qscale = qscale
        qp = int(round(qscale2qp(qscale)))
        qp = max(self.qp_min, min(self.qp_max, qp))
        self._pending = (slice_type, satd_cost, qp2qscale(qp), rceq)
        return qp

    @spanned("ratecontrol")
    def set_lookahead(self, entries) -> None:
        """Feed the costs of upcoming (not yet coded) frames in encode
        order: [(slice_type, satd_cost), ...]. Used by the VBV clip to
        simulate the buffer over the plan instead of one frame (x265
        updateVbvPlan + clipQscale's lookahead loop,
        ratecontrol.cpp:2283-2450)."""
        self._la_window = list(entries)[:32]

    def _clip_vbv(self, slice_type: int, satd: float, qscale: float) -> float:
        if not self.vbv:
            return qscale
        pred = self.pred[slice_type]
        window = getattr(self, "_la_window", [])
        floor_ = 0.15 * self.vbv_bufsize

        def simulate(q):
            """Buffer fill trajectory at plan qscale q; True = safe."""
            bits = pred.value * satd / q + pred.offset
            fill = self.buffer_fill - bits + self.buffer_rate
            if fill < floor_:
                return False, fill
            f = fill
            for (st2, c2) in window:
                q2 = q
                if st2 == I_SLICE:
                    q2 = q / self.ip_factor
                elif st2 == B_SLICE:
                    q2 = q * self.pb_factor
                p2 = self.pred[st2]
                b2 = p2.value * c2 / q2 + p2.offset
                f = min(self.vbv_bufsize, f + self.buffer_rate) - b2
                if f < floor_:
                    return False, fill
            return True, fill

        for _ in range(32):
            ok, fill_after = simulate(qscale)
            if not ok:
                qscale *= 1.15           # plan underflows: coarser
            elif (fill_after > 0.95 * self.vbv_bufsize and
                  qscale > qp2qscale(8)):
                qscale /= 1.1            # buffer overflowing: spend more
            else:
                break
        return qscale

    def note_cutree(self, off) -> None:
        """Pass-1: attach this frame's cuTree offset map to the next
        end() record so the stats file carries it (x265 cuTree stat
        files, ratecontrol.h:237-252)."""
        self._pending_cutree = (off.tolist()
                                if hasattr(off, "tolist") else off)

    def cutree_from_stats(self):
        """Pass-2: the recorded cuTree offsets for the frame whose
        start() was just issued (encode order), or None."""
        import numpy as np
        if self.pass2_qp is None or not getattr(self, "pass2_cutree", None):
            return None
        idx = self.pass2_idx - 1          # start() already advanced it
        if 0 <= idx < len(self.pass2_cutree):
            ct = self.pass2_cutree[idx]
            return None if ct is None else np.asarray(ct, np.float64)
        return None

    @spanned("ratecontrol")
    def reencode_qp(self, bits: int):
        """Post-encode VBV emergency gate — the whole-frame re-imagining
        of x265's row-level VBV re-encode (rowVbvRateControl,
        ratecontrol.cpp:2526): if the frame as coded would underflow the
        CPB, return a conservatively higher QP for ONE re-encode of the
        same picture; otherwise None. Call before end()."""
        if not self.vbv or self._pending is None:
            return None
        fill_after = self.buffer_fill - bits + self.buffer_rate
        hard_floor = 0.05 * self.vbv_bufsize
        if fill_after >= hard_floor:
            return None
        qscale = self._pending[2]
        budget = max(1.0, self.buffer_fill + self.buffer_rate - hard_floor)
        ratio = bits / budget             # linear bits ~ 1/qscale model
        new_qs = qscale * min(4.0, max(1.25, ratio))
        qp = int(math.ceil(qscale2qp(new_qs)))
        qp = max(self.qp_min, min(self.qp_max, qp))
        cur = int(round(qscale2qp(qscale)))
        if qp <= cur:
            return None
        # band-graded emergency (the x265 rowVbvRateControl shape,
        # ratecontrol.cpp:2526: QP climbs as the buffer deteriorates
        # through the frame): the re-encode's CTB rows ramp from about
        # half the delta at the top to ~1.5x at the bottom, averaging
        # the uniform emergency QP — early rows keep quality, late rows
        # absorb the emergency. Consumed by the encoder's qp_map build.
        self.band_grad_pending = qp - cur
        # keep the model pointed at the re-encode operating point
        self._pending = (self._pending[0], self._pending[1],
                         qp2qscale(qp)) + tuple(self._pending[3:])
        self.last_qscale = qp2qscale(qp)
        return qp

    @spanned("ratecontrol")
    def end(self, bits: int) -> None:
        """Account a coded frame (x265 rateControlEnd)."""
        st = self._pending[0] if self._pending else P_SLICE
        satd = self._pending[1] if self._pending else 1.0
        qscale = self._pending[2] if self._pending else self.last_qscale
        self.total_bits += bits
        self.frames_coded += 1
        if self.pass_num == 1:
            rec = {
                "type": {I_SLICE: "I", P_SLICE: "P", B_SLICE: "B"}[st],
                "cost": satd, "bits": bits, "qscale": qscale}
            ct = getattr(self, "_pending_cutree", None)
            if ct is not None:
                rec["cutree"] = ct
                self._pending_cutree = None
            self.pass1_records.append(rec)
        if self.mode == RC_ABR and self._pending and len(self._pending) > 3:
            rceq = self._pending[3]
            # normalize P-frame equivalent qscale (undo I/B modulation)
            q = qscale
            if st == I_SLICE:
                q *= IP_FACTOR
            elif st == B_SLICE:
                q /= PB_FACTOR
            self.cplxr_sum += bits * q / max(1e-6, rceq)
            self.wanted_bits_window += self.bitrate / self.fps
        if self.vbv:
            self.pred[st].update(bits, satd, qscale)
            self.buffer_fill = min(
                self.vbv_bufsize,
                max(0.0, self.buffer_fill - bits + self.buffer_rate))
        self._pending = None


def parse_zones(spec: str):
    """Parse the x265 --zones string: "start,end,q=QP" or
    "start,end,b=MULT" ranges joined by "/" (x265 x265.h:zones,
    param.cpp parseZones analog)."""
    zones = []
    if not spec:
        return zones
    for part in spec.split("/"):
        part = part.strip()
        if not part:
            continue
        fields = part.split(",")
        if len(fields) != 3 or "=" not in fields[2]:
            raise ValueError(f"bad zone: {part}")
        key, val = fields[2].split("=", 1)
        z = {"start": int(fields[0]), "end": int(fields[1])}
        if key.strip().lower() == "q":
            z["q"] = int(val)
        elif key.strip().lower() == "b":
            z["b"] = float(val)
        else:
            raise ValueError(f"bad zone option: {key}")
        if z["end"] < z["start"]:
            raise ValueError(f"zone end < start: {part}")
        zones.append(z)
    return zones
