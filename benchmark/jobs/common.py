"""What the jobs share: the system's model configuration from a
configuration file, the weights the benchmark made, the first step's
captures, and the pieces the per-layer metrics time."""

from __future__ import annotations

import torch

from dpc_tpu_torch.core.config import DPCConfig


def model_config(cfg: dict) -> DPCConfig:
    """The configuration file's model as the system's ``DPCConfig``, with
    the recurrence kernel the CLIs force (``gru_impl="pallas"``)."""
    return DPCConfig(img_dim=cfg["img_dim"], num_seq=cfg["num_seq"],
                     seq_len=cfg["seq_len"], pred_step=cfg["pred_step"],
                     network=cfg["network"],
                     gru_kernel_size=cfg["gru_kernel_size"],
                     gru_num_layers=cfg["gru_num_layers"],
                     gru_dropout=cfg["gru_dropout"], gru_impl="pallas",
                     compute_dtype=cfg["compute_dtype"])


class Job:
    """One train step of the system with its model and optimizer.
    Subclasses build them and define ``call``, ``capture`` and ``piece``."""

    name = ""
    pieces: tuple = ()

    def __init__(self, cfg: dict, traffic: dict, device, mesh):
        self.cfg, self.traffic, self.device, self.mesh = (cfg, traffic,
                                                          device, mesh)
        self.mcfg = model_config(cfg)

    def load(self, weights: dict) -> None:
        """The benchmark's weights into the model, whose parameters must
        be exactly the reference's, by name and shape."""
        params = dict(self.model.named_parameters())
        if {k: tuple(v.shape) for k, v in params.items()} != {
                k: tuple(v.shape) for k, v in weights.items()}:
            raise RuntimeError("the system's parameters differ from the "
                               "reference's by name or shape")
        with torch.no_grad():
            for k, p in params.items():
                p.copy_(weights[k])

    def params(self) -> dict:
        return dict(self.model.named_parameters())

    def first_gradients(self) -> dict:
        """Each leaf's first gradient as Adam got it (decay included),
        worked out from its first moment after one step, on the host."""
        beta1 = self.optimizer.param_groups[0]["betas"][0]
        out = {}
        for k, p in self.params().items():
            state = self.optimizer.state.get(p, {})
            if "exp_avg" in state:
                out[k] = (state["exp_avg"] / (1 - beta1)).float().cpu()
        return out

    def capture_recipe(self, got: dict, keep: bool = True):
        """A hook that keeps the first input the backbone sees, the
        recipe's output, on the host (when ``keep``)."""
        def hook(_module, args):
            if keep:
                got.setdefault("recipe", args[0].detach().float().cpu())
        return self.model.backbone.register_forward_pre_hook(hook)

    def stem_piece(self, x):
        """The stem's forward and backward as the backbone calls it, on
        the recipe's output ``x`` [B, N, SL, H, W, 3]."""
        model, dev = self.model, self.device
        bf16 = self.cfg["compute_dtype"] == "bfloat16"
        h = x.reshape(-1, *x.shape[2:]).permute(0, 4, 1, 2, 3)
        with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
            y = model.backbone.stem(h)
        gy = torch.randn_like(y)
        del y

        def run():
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
                out = model.backbone.stem(h)
            out.backward(gy)
        return run

    def gru_piece(self, x, dropout_gen):
        """The aggregator's forward and backward over ``x`` [B, T, S, S,
        D], as the step runs it under its autocast."""
        dev = self.device
        bf16 = self.cfg["compute_dtype"] == "bfloat16"
        x.requires_grad_(True)

        def run():
            with torch.autocast(dev.type, dtype=torch.bfloat16, enabled=bf16):
                last = self.gru_call(x, dropout_gen)
            last.float().sum().backward()
        return run

    def gru_call(self, x, dropout_gen):
        raise NotImplementedError
