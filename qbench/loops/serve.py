"""The serving loop: ``qasr_torch.infer.Transcriber(cfg=..., params=...,
beam=False).transcribe_batch``, one request (a list of waveforms) at a
time from one client: closed loop, one request in flight.

Each request is timed on the host from the call to the returned
transcripts. Hooks on the served model's call keep, for a seeded sample of
the window's requests (the longest among them), the features the front end
made and the logits the model returned; the check compares them, and the
returned transcripts, with the plain reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from qbench import checks
from qbench.loops.train import program_config
from qbench.reference import decode as ref_decode
from qbench.reference import frontend as ref_frontend
from qbench.reference import model as ref_model
from qbench.reference.precision import exact_f32
from qbench.traffic import utterances

#: requests the check samples, besides the longest
SAMPLED = 3
#: the traced run's profiled stretch, in requests
PROFILE_ITEMS = 12


class Loop:
    def __init__(self, ctx):
        self.ctx = ctx
        self.tr = None
        self.i = 0
        self.captured = {}
        self.latencies = []
        self.failed = 0

    def _wseed(self):
        return utterances.subseed(self.ctx.seed, "weights") % 2**62

    def prepare(self):
        """The requests and the sample of them the check compares, from the
        seed (what the reference needs too)."""
        ctx = self.ctx
        if list(ctx.mix["buckets"]) != list(ctx.conf["data"]["bucket_sizes"]):
            raise ValueError("the mix's buckets are not the configuration's bucket_sizes")
        self.pool = utterances.serve_pool(ctx.mix, ctx.seed, ctx.device)
        rng = np.random.default_rng(utterances.subseed(ctx.seed, "sample"))
        n = len(self.pool)
        longest = max(range(n), key=lambda i: (self.pool[i]["band"], self.pool[i]["audio_s"]))
        others = [i for i in range(n) if i != longest]
        self.sample = {longest, *rng.choice(others, size=min(SAMPLED, len(others)),
                                            replace=False).tolist()}

    def setup(self):
        from qasr_torch.infer import Transcriber

        ctx, dev = self.ctx, self.ctx.device
        conf = ctx.conf
        self.prepare()
        cfg = program_config(conf, utterances.subseed(ctx.seed, "init") % 2**31)
        params = ref_model.make_params(conf["model"], conf["data"]["n_mels"], self._wseed(), dev)
        self.tr = Transcriber(cfg=cfg, params=params, beam=False, device=dev)
        del params
        self._want = None
        self.tr.model.register_forward_pre_hook(self._pre, with_kwargs=True)
        self.tr.model.register_forward_hook(self._post)
        # every band the traffic uses, twice, before the window
        seen: dict[int, int] = {}
        for req in self.pool * 2:
            if seen.get(req["band"], 0) < 2:
                self.tr.transcribe_batch(req["wavs"])
                seen[req["band"]] = seen.get(req["band"], 0) + 1

    def _pre(self, module, args, kwargs):
        if self._want is not None:
            self._want["feats"] = args[0].detach().clone()
            self._want["lengths"] = kwargs["lengths"].detach().clone()

    def _post(self, module, args, out):
        if self._want is not None:
            self._want["logits"] = out.detach().clone()

    def step(self) -> dict:
        pos = self.i
        req = self.pool[pos % len(self.pool)]
        self.i += 1
        self._want = {} if pos in self.sample else None
        t0 = time.perf_counter()
        try:
            texts = self.tr.transcribe_batch(req["wavs"])
        except RuntimeError:
            self.failed += 1
            texts = None
        lat = time.perf_counter() - t0
        if self._want is not None and texts is not None:
            self._want["texts"] = texts
            self.captured[pos] = self._want
        self._want = None
        self.latencies.append(lat)
        frames = sum(1 + (len(w) - 400) // 160 for w in req["wavs"])
        return {"audio_s": req["audio_s"], "latency_s": lat, "real_frames": frames,
                "rows": len(req["wavs"]), "t_pad": req["band"]}

    def sync(self):
        if self.ctx.device.startswith("cuda"):
            torch.cuda.synchronize()

    def outcome(self) -> tuple[int, int]:
        return len(self.latencies), self.failed

    def release(self):
        self.tr = None

    def samples(self, prec_front: str = "f32", prec_model: str = "f32",
                program: bool = True) -> list[dict]:
        """The sampled utterances with the reference's features, logits and
        decode; with ``program`` False the reference at the given
        precisions stands in the program's place (the control)."""
        ctx, dev = self.ctx, self.ctx.device
        conf = ctx.conf
        model, data = conf["model"], conf["data"]
        dataset = data["dataset"]
        params = ref_model.make_params(model, data["n_mels"], self._wseed(), dev)
        out = []
        with torch.no_grad(), exact_f32():
            for pos in sorted(self.captured if program else self.sample):
                cap = self.captured.get(pos)
                req = self.pool[pos % len(self.pool)]
                ref = self._ref_logits(params, conf, req["wavs"], "f32", "f32")
                if program:
                    got = cap
                else:
                    got = self._ref_logits(params, conf, req["wavs"], prec_front, prec_model)
                    got["texts"] = [ref_decode.to_symbols(ref_decode.best_path(
                        got["logits"][n, :t].argmax(-1).tolist()), dataset)
                        for n, t in enumerate(got["lengths"].tolist())]
                for n, t in enumerate(ref["lengths"].tolist()):
                    served = got["logits"][n, :t].float()
                    text = ref_decode.to_symbols(
                        ref_decode.best_path(served.argmax(-1).tolist()), dataset)
                    out.append({"feats": got["feats"][n, :t].float().cpu(),
                                "ref_feats": ref["feats"][n, :t].cpu(),
                                "logits": served.cpu(), "ref_logits": ref["logits"][n, :t].cpu(),
                                "text": got["texts"][n], "ref_text": text})
        return out

    @staticmethod
    def _ref_logits(params, conf, wavs, prec_front, prec_model) -> dict:
        """The reference's features (padded with zeros to the request's
        band, as the serving path pads a batch) and its eval-mode logits."""
        dev = next(iter(params.values())).device
        data, model = conf["data"], conf["model"]
        feats = [ref_frontend.featurize(w, data["n_mels"], data["sample_rate"], dev, prec_front)
                 for w in wavs]
        lens = torch.tensor([f.shape[0] for f in feats], device=dev)
        band = utterances.serve_band(int(lens.max()), data["bucket_sizes"])
        x = torch.zeros((len(feats), band, data["n_mels"], 4), device=dev)
        for n, f in enumerate(feats):
            x[n, : f.shape[0]] = f
        logits = ref_model.forward(params, model, x, lens, prec=prec_model)
        return {"feats": x, "lengths": lens, "logits": logits}

    def check(self) -> dict:
        return checks.serve_numbers(self.samples())
