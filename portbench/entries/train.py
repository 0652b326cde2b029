"""The ``train`` entry: a closed loop of ``TrainHandles.step`` of
``avjepa_tpu_torch.train.pretrain``, one step after the previous one has
finished, as a training job runs.

The steps take host batches: float32 numpy clips in pageable memory, as the
loader hands them, each with its own masks from the benchmark's frozen
sampler (``masks.py``): the same set of draws for every seed, in the seed's
order, so that every seed does the same work. So a call holds the
host-to-device copy and cast and the whole train step. The handles come from
``pretrain.setup`` on the configuration's YAML; its loader is closed unused.

Set-up builds the program, loads the benchmark's weights into it, makes the
batches and warms every batch's shapes through the window's own call. The
first calls are the ones the reference follows: their losses, the first
step's gradient as the optimizer holds it, and the parameters' change are
kept for ``numbers``, which runs the reference once the program is released.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench import check, flops, masks, program, weights
from portbench.reference import train as ref_train
from portbench.reference.vit import ModelSpec, Numerics


def program_masks(draws: list) -> list:
    """The program's masks of one batch (a ``MaskSet`` a mask config) from the
    frozen sampler's dense draws: the compacted paths' index arrays built by
    the program's own helper, so that their format stays the program's."""
    from avjepa_tpu_torch.masks.multiblock3d import MaskSet, _bucket_pad

    out = []
    for d in draws:
        b, n = d.enc.shape
        out.append(MaskSet(d.enc, d.pred,
                           _bucket_pad([np.flatnonzero(r) for r in d.enc], b, n),
                           _bucket_pad([np.flatnonzero(r) for r in d.enc | d.pred], b, n)))
    return out


class Cell:
    """One ``train`` cell: the program's handles, the host batches and what
    the reference compares (the interface every entry keeps: ``spec.py``)."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device):
        self.spec = ModelSpec.from_json(conf["model"])
        self.opt = ref_train.OptSpec.from_json(conf["train"])
        self.yaml = program.program_yaml(conf, "pretrain")
        self.check_steps = int(conf["check_steps"])
        self.traffic, self.seed, self.device = traffic, seed, device
        self.batch = int(self.yaml["data"]["batch_size"])
        s = self.spec
        clip_bytes = 4 * (s.num_frames * s.crop_size ** 2 * 3
                          + (s.spec_height * s.spec_width if s.audio else 0))
        self.k = max(self.check_steps, min(int(traffic["max_batches"]),
                                           int(traffic["host_bytes"] // (clip_bytes * self.batch))))
        self.failed = 0

    # -- set-up ---------------------------------------------------------
    def setup(self) -> None:
        from avjepa_tpu_torch.config import load_config
        from avjepa_tpu_torch.train import pretrain

        self.h = pretrain.setup(load_config(self.yaml), self.device)
        self.h.loader.close()
        self.prepare(self.seed)

    def prepare(self, seed: int, warm: bool = True) -> None:
        """The program at step 0 with the weights of ``seed``, the batches of
        ``seed``, the first ``check_steps`` steps taken and kept, and (with
        ``warm``) one step on each other batch."""
        self.seed = seed
        st = self.h.state
        enc, pred = weights.make(self.spec, seed, self.device)
        st.encoder.load_state_dict(enc)
        st.target_encoder.load_state_dict(enc)
        st.predictor.load_state_dict(pred)
        st.optimizer.state.clear()
        st.step = 0
        del enc, pred
        g = weights.generator(seed, 3, self.device)
        # the same k mask draws (from the YAML's meta.seed) for every seed, so
        # that every seed does the same work; the seed orders them
        sampler = masks.MaskCollator(self.yaml["mask"], program.grid(self.spec),
                                     base_seed=int(self.yaml["meta"]["seed"]))
        draws = [sampler(self.batch) for _ in range(self.k)]
        order = np.random.default_rng(weights.stream_seed(seed, 4)).permutation(self.k)
        self.batches, self.counts = [], []
        for j in order:
            video, audio = weights.clips(self.spec, self.batch, g, self.device)
            self.batches.append((video.cpu().numpy(),
                                 None if audio is None else audio.cpu().numpy(),
                                 program_masks(draws[j])))
            self.counts.append([flops.mask_counts(d.enc, d.pred, self.spec.num_video_tokens)
                                for d in draws[j]])
            del video, audio
        losses, grad = [], {}
        for i in range(self.check_steps):
            losses.append(self.call_metrics(i)["loss"])
            if i == 0:
                grad = self._grad_norms()
        self.prog = {"losses": losses, "grad": grad, "change": self._change_norms()}
        for i in range(self.check_steps, self.k if warm else 0):  # the other batches' shapes
            self.call(i)

    def _named(self):
        st = self.h.state
        return [(f"{m}.{n}", p) for m, mod in (("encoder", st.encoder), ("predictor", st.predictor),
                                               ("target_encoder", st.target_encoder))
                for n, p in mod.named_parameters()]

    def _grad_norms(self) -> dict:
        """Each leaf's gradient at the first step, as AdamW holds it: its
        first moment over 1 - beta1."""
        opt = self.h.state.optimizer
        beta1 = opt.param_groups[0]["betas"][0]
        named = [(n, p) for n, p in self._named() if not n.startswith("target_encoder.")]
        norms = [torch.linalg.vector_norm(opt.state[p]["exp_avg"].double()) / (1.0 - beta1)
                 if p in opt.state and "exp_avg" in opt.state[p]
                 else torch.zeros((), dtype=torch.float64, device=p.device) for _, p in named]
        return dict(zip((n for n, _ in named), torch.stack(norms).tolist()))

    @torch.no_grad()
    def _change_norms(self) -> dict:
        enc0, pred0 = weights.make(self.spec, self.seed, self.device)
        start = {"encoder": enc0, "predictor": pred0, "target_encoder": enc0}
        named = self._named()
        norms = torch.stack([torch.linalg.vector_norm((p - start[n.split(".", 1)[0]][
            n.split(".", 1)[1]]).double()) for n, p in named]).tolist()
        return dict(zip((n for n, _ in named), norms))

    # -- the window's call ------------------------------------------------
    def call_metrics(self, i: int) -> dict:
        video, audio, ms = self.batches[i % self.k]
        return self.h.step(video, audio, ms, full_metrics=bool(self.traffic["full_metrics"]))

    def call(self, i: int) -> int:
        if not math.isfinite(self.call_metrics(i)["loss"]):
            self.failed += 1
        return self.batch

    def flops(self, i: int) -> float:
        return flops.train_flops(self.spec, self.batch, self.counts[i % self.k])

    def attention(self, i: int) -> list:
        return flops.train_attention(self.spec, self.batch, self.counts[i % self.k])

    def launches_match(self, i: int, fwd: int, bwd: int) -> bool:
        return flops.launches_match(self.attention(i), self.spec, len(self.counts[0]), fwd, bwd)

    # -- the comparison ---------------------------------------------------
    def release(self) -> None:
        del self.h
        program.release()

    def _ref_batch(self, i: int):
        video, audio, ms = self.batches[i]
        dev = self.device
        idx = [(torch.from_numpy(np.stack([np.flatnonzero(r) for r in m.enc])).to(dev),
                torch.from_numpy(np.stack([np.flatnonzero(r) for r in m.pred])).to(dev))
               for m in ms]
        return (torch.from_numpy(video).to(dev),
                None if audio is None else torch.from_numpy(audio).to(dev), idx)

    def reference(self, numerics: str = "float32", half_batch: bool = False) -> dict:
        """The reference's first ``check_steps`` steps from this seed's
        weights and batches."""
        program.reference_numerics()
        enc0, pred0 = weights.make(self.spec, self.seed, self.device)
        batches = [self._ref_batch(i) for i in range(self.check_steps)]
        out = ref_train.train(self.spec, self.opt, enc0, pred0, batches, self.check_steps,
                              Numerics(numerics), half_batch=half_batch)
        del enc0, pred0, batches
        program.release()
        return out

    def numbers(self) -> dict:
        return check.train_numbers(self.prog, self.reference())

    def readings(self, seed: int, program: bool, control: bool) -> dict:
        """The calibration's readings of ``seed`` (``calibrate.py``): the
        program's first steps against the reference; the control (the
        reference in float8) and the fault of half of each batch left out,
        planted in the reference."""
        self.prepare(seed, warm=False)
        ref = self.reference()
        out = {}
        if program:
            out["program"] = check.train_numbers(self.prog, ref)
        if control:
            out["control"] = check.train_numbers(self.reference("fp8"), ref)
            out["half_batch"] = check.train_numbers(self.reference(half_batch=True), ref)
        return out
