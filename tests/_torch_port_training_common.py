"""Shared pieces of the training tests (`test_torch_port_training*.py`): the
8² UNet and its schedule, a fresh train state, a seeded batch, and the
comparison of two parameter dicts.
"""
import torch

from fidm_tpu_torch.diffusion import DiffusionSchedule
from fidm_tpu_torch.models import InpaintingUNet, UNetConfig
from fidm_tpu_torch.training import TrainState, init_ema, make_lr_schedule, make_optimizer


CFG = UNetConfig(image_size=8, in_channels=9, model_channels=32, out_channels=6,
                 num_res_blocks=1, attention_resolutions=(2,), channel_mult=(1, 2),
                 num_heads=1, num_head_channels=32, dtype=torch.float32)
SCHED = DiffusionSchedule.create("linear", 20, device="cpu")
# the keys of the JAX loop's history entries
HISTORY_KEYS = {"epoch", "train_loss", "val_loss", "seconds"}


def _state(lr=1e-3, seed=0, ema=False):
    torch.manual_seed(seed)
    model = InpaintingUNet(CFG)
    with torch.no_grad():  # no zero-initialised conv: every parameter learns
        for p in model.parameters():
            p.add_(0.05 * torch.randn_like(p))
    params = dict(model.named_parameters())
    return TrainState.create(model, params, make_optimizer(make_lr_schedule("none", lr, 10)),
                             ema_params=init_ema(params) if ema else None)


def _batch(seed=1, B=2):
    g = torch.Generator().manual_seed(seed)
    S = CFG.image_size
    img = 0.5 * torch.randn((B, S, S, 3), generator=g)
    mask = torch.zeros((B, S, S, 1))
    mask[:, : S // 2] = 1.0
    return {"image": img, "masked_image": img * (1 - mask), "mask": mask}


def _params_equal(a, b):
    return all(torch.equal(a[k], b[k]) for k in a)
