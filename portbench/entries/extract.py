"""The ``extract`` entry: a closed loop of ``serve.extract.encode`` (mean
pooling, feature LayerNorm) on float32 batches kept on the device, each
batch's embeddings then copied to the host, as the extract app does a batch.

Set-up builds the encoder (``extract.build_encoder``), loads the benchmark's
weights into it, makes the batches and encodes each once. ``numbers`` holds
every embedding the window returned against the reference's.
"""

from __future__ import annotations

import torch

from portbench import check, flops, program, weights
from portbench.reference.vit import ModelSpec, Numerics, embed_clips


class Cell:
    """One ``extract`` cell: the program's encoder, the device batches and
    every embedding the window returned."""

    def __init__(self, conf: dict, traffic: dict, seed: int, device: torch.device):
        self.spec = ModelSpec.from_json(conf["model"])
        self.yaml = program.program_yaml(conf, "extract")
        self.traffic, self.seed, self.device = traffic, seed, device
        self.batch = int(self.yaml["data"]["batch_size"])
        self.k = int(traffic["max_batches"])
        self.failed = 0
        self.outputs: list = []

    def setup(self) -> None:
        from avjepa_tpu_torch.config import load_config
        from avjepa_tpu_torch.serve import extract

        self.cfg = load_config(self.yaml)
        self.encoder = extract.build_encoder(self.cfg, self.device)
        self._encode = extract.encode
        self.prepare(self.seed)

    def prepare(self, seed: int, warm: bool = True) -> None:
        """The weights and batches of ``seed``; with ``warm``, every batch
        encoded once."""
        self.seed = seed
        enc, _ = weights.make(self.spec, seed, self.device, predictor=False)
        self.encoder.load_state_dict(enc)
        del enc
        g = weights.generator(seed, 3, self.device)
        self.batches = [weights.clips(self.spec, self.batch, g, self.device) for _ in range(self.k)]
        for i in range(self.k if warm else 0):
            self.call(i)
        self.outputs.clear()

    def call(self, i: int) -> int:
        video, audio = self.batches[i % self.k]
        out = self._encode(self.encoder, video, audio, self.cfg.extract).cpu().numpy()
        self.outputs.append((i % self.k, out))
        return len(out)

    def flops(self, i: int) -> float:
        return flops.encode_flops(self.spec, self.batch)

    def attention(self, i: int) -> list:
        return flops.encode_attention(self.spec, self.batch)

    def launches_match(self, i: int, fwd: int, bwd: int) -> bool:
        return flops.launches_match(self.attention(i), self.spec, 1, fwd, bwd)

    def release(self) -> None:
        del self.encoder
        program.release()

    def reference(self, numerics: str = "float32") -> dict:
        """The reference's embeddings of every batch the window used."""
        program.reference_numerics()
        enc0, _ = weights.make(self.spec, self.seed, self.device, predictor=False)
        used = sorted({k for k, _ in self.outputs})
        refs = {k: embed_clips(enc0, self.spec, *self.batches[k], Numerics(numerics)).cpu().numpy()
                for k in used}
        del enc0
        program.release()
        return refs

    def numbers(self) -> dict:
        return check.embed_numbers(self.outputs, self.reference(), self.batch)

    def readings(self, seed: int, program: bool, control: bool) -> dict:
        """The calibration's readings of ``seed`` (``calibrate.py``): every
        batch encoded once by the program, and by the control (the reference
        in float8), against the reference."""
        self.prepare(seed, warm=False)
        for i in range(self.k):
            self.call(i)
        refs = self.reference()
        out = {}
        if program:
            out["program"] = check.embed_numbers(self.outputs, refs, self.batch)
        if control:
            out["control"] = check.embed_numbers(list(self.reference("fp8").items()), refs,
                                                 self.batch)
        return out
