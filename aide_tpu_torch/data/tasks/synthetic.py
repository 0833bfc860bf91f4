"""Synthetic ellipse-segmentation task (no files needed).

An own copy of ``aide_tpu.data.tasks.synthetic``: the same deterministic
generator (same seeds, same draws, same pixels), with the same contract as
the real tasks: cases, slices, clean or noisy labels, a two-modal option and
a tempmask disk mirror.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from aide_tpu_torch.core.registry import TASKS
from aide_tpu_torch.data.io import png
from aide_tpu_torch.data.tasks.base import SliceSpec, Task, gray_to_rgb

# Appearance "domains" for the cross-domain transfer regime (the reference's
# prostate ISBI-3T vs ISBI-DX protocol: same anatomy, different scanner).
# Only APPEARANCE distributions differ; the anatomy (shape) draws are shared,
# so case k has the same organ in every domain. Per-image normalization
# removes base/global-gain shifts, so the learnable gap lives in the
# contrast-to-noise ratio, bias-field strength, and distractor rendering.
_DOMAINS = {
    # bright-fg, mild bias, clean-ish: the "3T" look
    "a": dict(contrast=(14.0, 28.0), base=(60.0, 110.0),
              noise=(9.0, 15.0), bias=10.0, d_gain=(0.7, 1.0)),
    # low CNR, heavy bias field, hot distractors: the "DX" look
    "b": dict(contrast=(7.0, 14.0), base=(130.0, 180.0),
              noise=(13.0, 22.0), bias=26.0, d_gain=(1.0, 1.6)),
    # midpoint of a and b: a MILD scanner shift. The a:b gap is
    # catastrophic (a source-only model annotates b at ~0.11 Dice —
    # experiments/synthetic_aide_transfer_ab.json); a:m sits in the regime
    # the reference's 3T<->DX protocol actually occupies, where the
    # source model's target annotations are usable and refresh can add
    # information rather than only limit damage.
    "m": dict(contrast=(10.0, 20.0), base=(95.0, 145.0),
              noise=(11.0, 18.0), bias=18.0, d_gain=(0.85, 1.3)),
}

# Frozen per-domain seed multipliers, the JAX package's: they must never
# change for an existing domain, or the renders part from the JAX task's;
# new domains append the next integer. Historically 1 + sorted(_DOMAINS).index(d),
# frozen here so future additions cannot shift earlier domains' draws.
_DOMAIN_SEED_MULT = {"a": 1, "b": 2, "m": 3}
assert set(_DOMAIN_SEED_MULT) == set(_DOMAINS)


@TASKS.register("synthetic")
class SyntheticTask(Task):
    name = "synthetic"
    two_modal = False

    def __init__(
        self,
        root: str = "",
        tempmask_folder: str = "tempmasks",
        two_modal: bool = False,
        num_cases: int = 6,
        slices_per_case: int = 8,
        size: int = 64,
        noisy_fraction: float = 0.0,
        clean_cases: int = 0,
        noise_shift_divisor: int = 8,
        num_classes: int = 2,
        style: str = "ellipse",
        seed: int = 0,
        domain_split: str = "",
        **kw,
    ):
        super().__init__(root or ".", tempmask_folder)
        self.two_modal = two_modal
        self.num_cases = num_cases
        self.slices_per_case = slices_per_case
        self.size = size
        self.noisy_fraction = noisy_fraction
        # num_classes > 2 draws one ellipse per foreground class (labels
        # 1..C-1); the reference only trains binary heads, this exercises
        # the engine's multi-class path (entropy weightmap, C-class losses)
        self.num_classes = num_classes
        # 'ellipse': high-contrast single ellipse (saturates from very few
        # clean cases — good for smoke tests). 'hard': star-convex shape
        # families with per-case anatomy, low contrast, a smooth bias field
        # and same-intensity distractor blobs — pretrain on a small clean
        # budget sits well below ceiling, giving the AIDE ladder the
        # headroom the medical tasks have (BASELINE.md: +0.072 on CHAOS).
        self.style = style
        # the first `clean_cases` cases keep clean labels — the "labeled"
        # annotation budget (the reference regimes always anchor on some
        # clean supervision: the exempt labeled CHAOS case, the prostate
        # labeled source domain, the breast 25 clean cases)
        self.clean_cases = clean_cases
        # corrupted masks are shifted by up to size/noise_shift_divisor px;
        # smaller divisor = heavier corruption
        self.noise_shift_divisor = noise_shift_divisor
        # held-out split: load_manifest(train=False) generates
        # ``num_test_cases`` cases starting at ``test_case_offset``.
        # offset 0 (default) keeps the historical behavior (test = the train
        # cases with clean labels); a large offset gives unseen anatomy.
        self.test_case_offset = int(kw.pop("test_case_offset", 0))
        self.num_test_cases = int(kw.pop("num_test_cases", num_cases))
        # cross-domain transfer: "src:tgt" (domains from _DOMAINS) renders
        # the labeled budget (cases < clean_cases) with the SOURCE domain's
        # appearance and every other train case plus the held-out test
        # split with the TARGET domain's — the synthetic analogue of the
        # reference's labeled-3T + unlabeled-DX prostate protocol. Empty
        # string = single domain.
        self.domain_split = domain_split
        if domain_split:
            parts = domain_split.split(":")
            if (
                len(parts) != 2
                or any(p not in _DOMAINS for p in parts)
            ):
                raise ValueError(
                    f"domain_split must be 'src:tgt' with domains in "
                    f"{sorted(_DOMAINS)}, got {domain_split!r}"
                )
            if style not in ("hard", "xhard"):
                raise ValueError(
                    "domain_split needs the hard/xhard generator styles"
                )
        if kw:
            # data.task_options is forwarded here verbatim; a swallowed typo
            # (e.g. noisy_fracton) would silently train with defaults
            raise TypeError(f"SyntheticTask: unknown options {sorted(kw)}")
        self.seed = seed

    def _domain_of(self, case: int) -> str:
        """Source domain for the labeled budget, target for everything else
        (including the held-out test segment — transfer is scored on the
        target domain, like the reference's crossdomain val CSVs)."""
        if not self.domain_split:
            return ""
        src, tgt = self.domain_split.split(":")
        return src if case < self.clean_cases else tgt

    def clean_case_ids(self):
        return [f"case{c:02d}" for c in range(self.clean_cases)]

    # ---- generation ----
    @staticmethod
    def _morph(mask: np.ndarray, steps: int, dilate: bool) -> np.ndarray:
        """Binary dilation/erosion with a 4-neighborhood (pure numpy)."""
        out = mask.astype(bool)
        for _ in range(steps):
            shifts = [
                np.roll(out, 1, 0), np.roll(out, -1, 0),
                np.roll(out, 1, 1), np.roll(out, -1, 1),
            ]
            if dilate:
                for sh in shifts:
                    out = out | sh
            else:
                for sh in shifts:
                    out = out & sh
        return out.astype(np.uint8)

    def _gen_hard(self, case: int, sl: int, rng, geom_out: Optional[dict] = None):
        """Star-convex shape families, low contrast, bias field, distractors.

        Per-case anatomy (shape harmonics, size, appearance) comes from a
        case-keyed generator so slices of one case look related; per-slice
        pose/noise comes from ``rng``."""
        s = self.size
        crng = np.random.default_rng(
            ((self.seed * 7 + 13) * 999983 + case * 613) % (2**31)
        )
        if self.style == "xhard":
            # 'xhard': much wider PER-CASE appearance/shape diversity, so a
            # single labeled case teaches far less — the pretrain<<ceiling
            # regime the pseudo-label (limited-annotation) protocol needs.
            # ('hard' keeps its exact draw order below for reproducibility.)
            r0 = s * (0.07 + 0.15 * crng.random())
            amp = 0.08 + 0.22 * crng.random()
            coef = crng.normal(0.0, amp, size=4)       # harmonics k=2..5
            phase = crng.uniform(0, 2 * np.pi, size=4)
            cy0 = s * (0.30 + 0.40 * crng.random())
            cx0 = s * (0.30 + 0.40 * crng.random())
            contrast = 8.0 + 20.0 * crng.random()      # vs per-case noise
            base = 60.0 + 50.0 * crng.random()
            noise_sigma = 10.0 + 12.0 * crng.random()
            n_distract = int(crng.integers(1, 5))
            ecc = 0.5 + 0.4 * crng.random()            # some nearly fg-like
            d_r = s * (0.05 + 0.07 * crng.random(n_distract))
        else:
            r0 = s * (0.11 + 0.09 * crng.random())
            coef = crng.normal(0.0, 0.16, size=4)      # harmonics k=2..5
            phase = crng.uniform(0, 2 * np.pi, size=4)
            cy0 = s * (0.30 + 0.40 * crng.random())
            cx0 = s * (0.30 + 0.40 * crng.random())
            contrast = 14.0 + 12.0 * crng.random()     # vs noise sigma 15
            base = 70.0 + 30.0 * crng.random()
            noise_sigma = 15.0
            n_distract = 2
            ecc = 0.8
            d_r = s * (0.05 + 0.05 * crng.random(n_distract))
        bias_amp = 12.0
        d_gain = contrast

        domain = self._domain_of(case)
        if domain:
            # domain shift = re-draw the APPEARANCE parameters from the
            # domain's distributions (case-keyed, so each case keeps one
            # coherent look); the shape draws above are untouched — the
            # same organ imaged by a different scanner
            drng = np.random.default_rng(
                (
                    (self.seed * 7 + 13) * 999983
                    + case * 613
                    + 104729 * _DOMAIN_SEED_MULT[domain]
                ) % (2**31)
            )
            spec = _DOMAINS[domain]

            def draw(lo_hi):
                lo, hi = lo_hi
                return lo + (hi - lo) * drng.random()

            contrast = draw(spec["contrast"])
            base = draw(spec["base"])
            noise_sigma = draw(spec["noise"])
            bias_amp = spec["bias"]
            d_gain = contrast * draw(spec["d_gain"])

        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        cy = cy0 + rng.normal(0, 0.03 * s)
        cx = cx0 + rng.normal(0, 0.03 * s)
        rot = rng.uniform(0, 2 * np.pi)
        theta = np.arctan2(yy - cy, xx - cx) + rot
        rad = np.hypot(yy - cy, xx - cx)
        rfun = r0 * (
            1.0
            + sum(
                coef[k] * np.sin((k + 2) * theta + phase[k])
                for k in range(4)
            )
        )
        mask = (rad <= np.maximum(rfun, 2.0)).astype(np.uint8)

        img = np.full((s, s), base, np.float32)
        img += contrast * mask
        # distractor blobs: same intensity bump, rounder shape, background
        # label — foreground must be told apart by SHAPE, not brightness
        d_masks = []
        for d in range(n_distract):
            dcy = s * rng.uniform(0.1, 0.9)
            dcx = s * rng.uniform(0.1, 0.9)
            ell = ((yy - dcy) / d_r[d]) ** 2 + ((xx - dcx) / (ecc * d_r[d])) ** 2
            d_masks.append((ell <= 1.0) & (mask == 0))
            img += d_gain * d_masks[-1]
        # smooth intensity bias field (gain inhomogeneity)
        gy, gx, gq = rng.normal(0, 1.0, size=3)
        ny, nx = (yy / s - 0.5), (xx / s - 0.5)
        img += bias_amp * (gy * ny + gx * nx + gq * (ny * nx) * 2.0)
        img += noise_sigma * rng.normal(size=(s, s))
        if geom_out is not None:
            geom_out["mask"] = mask
            geom_out["d_masks"] = d_masks
        return img, mask

    def _render_modal2(self, case: int, sl: int, geom: dict) -> np.ndarray:
        """Second-modality rendering of the SAME scene — the CHAOS T1
        in-phase/out-phase analogue (dataset_chaos/*: the two channels are
        one acquisition with different tissue contrast). Per-case appearance
        comes from an independent case-keyed stream; noise and bias are
        independent per-slice draws, so the two modalities carry
        complementary information: foreground contrast is INVERTED (fg
        darker) and the distractor blobs are rendered with their own
        (usually weaker) gain, so fusing modalities genuinely
        disambiguates where one alone cannot."""
        s = self.size
        crng2 = np.random.default_rng(
            ((self.seed * 7 + 13) * 999983 + case * 613 + 7919) % (2**31)
        )
        rng2 = np.random.default_rng(
            (self.seed * 1000003 + case * 1009 + sl + 500009) % (2**31)
        )
        base2 = 120.0 + 60.0 * crng2.random()
        contrast2 = -(10.0 + 18.0 * crng2.random())   # fg darker
        d_gain = contrast2 * (0.1 + 0.6 * crng2.random())
        noise_sigma2 = 10.0 + 12.0 * crng2.random()
        bias_amp2 = 12.0
        domain = self._domain_of(case)
        if domain:
            # the domain is a SCANNER, so both acquisitions shift with it:
            # re-draw modal2's appearance from the domain's distributions
            # (case-keyed like modal1's, offset stream), keeping modal2's
            # conventions — inverted fg contrast, weaker distractor gain
            drng2 = np.random.default_rng(
                (
                    (self.seed * 7 + 13) * 999983
                    + case * 613 + 7919
                    + 104729 * _DOMAIN_SEED_MULT[domain]
                ) % (2**31)
            )
            spec = _DOMAINS[domain]

            def draw2(lo_hi):
                lo, hi = lo_hi
                return lo + (hi - lo) * drng2.random()

            base2 = draw2(spec["base"]) + 30.0
            contrast2 = -1.2 * draw2(spec["contrast"])
            noise_sigma2 = draw2(spec["noise"])
            bias_amp2 = spec["bias"]
            d_gain = contrast2 * 0.4 * draw2(spec["d_gain"])
        img = np.full((s, s), base2, np.float32)
        img += contrast2 * geom["mask"]
        for dm in geom["d_masks"]:
            img += d_gain * dm
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        ny, nx = (yy / s - 0.5), (xx / s - 0.5)
        gy, gx, gq = rng2.normal(0, 1.0, size=3)
        img += bias_amp2 * (gy * ny + gx * nx + gq * (ny * nx) * 2.0)
        img += noise_sigma2 * rng2.normal(size=(s, s))
        return np.clip(img, 0, 255).astype(np.float32)

    def _gen(self, case: int, sl: int, geom_out: Optional[dict] = None):
        rng = np.random.default_rng(
            (self.seed * 1000003 + case * 1009 + sl) % (2**31)
        )
        if self.style in ("hard", "xhard"):
            img, mask = self._gen_hard(case, sl, rng, geom_out)
            img = np.clip(img, 0, 255).astype(np.float32)
            noisy = mask
            if case >= self.clean_cases and rng.random() < self.noisy_fraction:
                lim = max(1, self.size // self.noise_shift_divisor)
                dy, dx = rng.integers(-lim, lim, size=2)
                noisy = np.roll(np.roll(mask, dy, 0), dx, 1)
                # plus boundary corruption: dilate or erode 1-2 px
                noisy = self._morph(
                    noisy, int(rng.integers(1, 3)), bool(rng.random() < 0.5)
                )
            return img, mask, noisy
        s = self.size
        yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
        if self.num_classes == 2:
            cy = s * (0.35 + 0.3 * rng.random())
            cx = s * (0.35 + 0.3 * rng.random())
            ry = s * (0.10 + 0.15 * rng.random())
            rx = s * (0.10 + 0.15 * rng.random())
            mask = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0).astype(
                np.uint8
            )
        else:
            # one ellipse per foreground class; later classes overwrite
            mask = np.zeros((s, s), np.uint8)
            for c in range(1, self.num_classes):
                cy = s * (0.2 + 0.6 * rng.random())
                cx = s * (0.2 + 0.6 * rng.random())
                ry = s * (0.08 + 0.10 * rng.random())
                rx = s * (0.08 + 0.10 * rng.random())
                ell = ((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2 <= 1.0
                mask[ell] = c
        base = 60 + 40 * rng.random()
        intensity = 120.0 / max(1, self.num_classes - 1)
        img = base + intensity * mask + 20.0 * rng.normal(size=(s, s))
        img = np.clip(img, 0, 255).astype(np.float32)
        noisy = mask
        if case >= self.clean_cases and rng.random() < self.noisy_fraction:
            # corrupt the label: shift the ellipse
            lim = max(1, s // self.noise_shift_divisor)
            dy, dx = rng.integers(-lim, lim, size=2)
            noisy = np.roll(np.roll(mask, dy, 0), dx, 1)
        return img, mask, noisy

    # ---- manifest ----
    def load_manifest(self, csv_path: str = "", train: bool = True) -> List[SliceSpec]:
        specs = []
        i = 0
        if train:
            case_range = range(self.num_cases)
        else:
            case_range = range(
                self.test_case_offset,
                self.test_case_offset + self.num_test_cases,
            )
        for case in case_range:
            for sl in range(self.slices_per_case):
                specs.append(
                    SliceSpec(
                        index=i,
                        case_id=f"case{case:02d}",
                        sort_key=f"case{case:02d}/{sl:03d}",
                        image_paths=(f"synthetic://{case}/{sl}",),
                        mask_path=f"synthetic://{case}/{sl}/mask",
                        depth=sl,
                        extras={"train": train, "case": case, "slice": sl},
                    )
                )
                i += 1
        return specs

    def decode_fingerprint(self) -> str:
        # every generator knob that changes pixels or labels for the same
        # specs (their paths are virtual, so the decode cache's file
        # signature cannot see them); render_v is the JAX package's
        # generator version, so that a cache of either package serves both
        return (
            "SyntheticTask:render_v=2,"
            f"style={self.style},seed={self.seed},"
            f"size={self.size},two_modal={self.two_modal},"
            f"noisy_fraction={self.noisy_fraction},"
            f"clean_cases={self.clean_cases},"
            f"noise_shift_divisor={self.noise_shift_divisor},"
            f"num_classes={self.num_classes},"
            f"domain_split={self.domain_split}"
        )

    # ---- decode ----
    def decode(self, spec: SliceSpec) -> Tuple[Tuple[np.ndarray, ...], np.ndarray]:
        geom: dict = {}
        img, mask, noisy = self._gen(
            spec.extras["case"], spec.extras["slice"],
            geom_out=geom if self.two_modal else None,
        )
        label = noisy if spec.extras.get("train", True) else mask
        rgb = gray_to_rgb(img.astype(np.uint8)).astype(np.float32)
        if self.two_modal:
            if self.style in ("hard", "xhard"):
                # independently-rendered second acquisition of the same
                # scene (see _render_modal2)
                m2 = self._render_modal2(
                    spec.extras["case"], spec.extras["slice"], geom
                )
            else:
                # ellipse style keeps the historical cheap second channel
                m2 = 255 - img
            inv = gray_to_rgb(m2.astype(np.uint8)).astype(np.float32)
            return (rgb, inv), label
        return (rgb,), label

    def clean_mask(self, spec: SliceSpec) -> np.ndarray:
        """Oracle ground truth (for test assertions on noisy configs)."""
        return self._gen(spec.extras["case"], spec.extras["slice"])[1]

    # ---- temp labels (PNG mirror, chaos-style) ----
    def tempmask_path(self, spec: SliceSpec, net: int) -> str:
        return os.path.join(
            self.root,
            self.tempmask_folder,
            spec.case_id,
            f"slice{spec.extras['slice']:03d}_net{net}.png",
        )

    def _png_scale(self) -> int:
        # labels 0..C-1 stored spread over 0..255 (255 for binary — the
        # historical format; 85 for C=4, etc.)
        return 255 // (self.num_classes - 1)

    def read_tempmask(self, spec: SliceSpec, net: int) -> Optional[np.ndarray]:
        path = self.tempmask_path(spec, net)
        if not os.path.exists(path):
            return None
        arr = png.read_mask(path).astype(np.float32)
        return np.round(arr / self._png_scale()).astype(np.uint8)

    def write_case_tempmask(
        self, specs: Sequence[SliceSpec], volume: np.ndarray, net: int
    ) -> None:
        for spec, sl in zip(specs, volume):
            path = self.tempmask_path(spec, net)
            self._ensure_dir(path)
            png.write_mask(path, sl, scale=self._png_scale())
