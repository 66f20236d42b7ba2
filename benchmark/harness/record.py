"""The states a sampling run passes through, recorded where the program's
model takes them: each denoiser call's input (the state before a jump) and
the decoder's input and output, chunk by chunk. The hooks hold references
to tensors the sampler makes anyway, so recording launches nothing; they
are attached only around the calls a check will follow."""

from __future__ import annotations

from typing import List


class Recorder:
    def __init__(self, model):
        self.model = model
        self.handles = []
        self.chunks: List[dict] = []
        self._cur = {"z": []}

    def start(self):
        self._cur = {"z": []}
        self.handles = [
            self.model.dynamics.register_forward_hook(self._dynamics),
            self.model.vae.decoder.register_forward_hook(self._decoder)]

    def stop(self) -> List[dict]:
        for h in self.handles:
            h.remove()
        self.handles = []
        out, self.chunks = self.chunks, []
        return out

    def _dynamics(self, module, args, output):
        self._cur["z"].append(args[1])

    def _decoder(self, module, args, output):
        self._cur["dec_in"] = args[0]
        self._cur["dec_out"] = output
        self.chunks.append(self._cur)
        self._cur = {"z": []}
