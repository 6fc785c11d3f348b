"""Training step: Adam over the current training block's weights (port of
`ldpc_error_floor_tpu/training/train.py`).

* The parameter dict always spans the full decode depth; block selection is
  a boolean row mask applied to the gradients.  With a fresh optimizer per
  block, masked rows keep zero moments and never move.
* Adam is `torch.optim.Adam` with optax's defaults (betas 0.9/0.999, eps
  1e-8); the learning rate lives in its param groups, so epoch-wise decay
  needs no rebuild.
* The [min_w, max_w] box constraint is applied to the trainable rows after
  every update; frozen-prefix rows loaded from a file pass through.

Parameters are a dict of leaf tensors that require gradients (`make_optimizer`
marks them); a step updates them in place.  On the card the decode goes
through the CUDA pair B4/B5 (`ops/fused_train.py`); on the CPU through the
plain version.  Nothing here reads a value back to the host: an epoch's
losses stay on the device until the caller reads their mean.

Under a mesh (`parallel.mesh`) each rank steps on its lanes of the global
batch; the masked gradients and the loss are summed over the ranks as one
flat buffer and divided by the world's size, so every rank takes the same
Adam step on the global batch's mean gradient and the parameters stay
replicated.

Under a profiler a step records host spans (`utils.profiling.annotate`):
``ldpc.train.sample`` (an epoch's batch), ``ldpc.train.forward`` (the
decode, B4 on the card), ``ldpc.train.loss``, ``ldpc.train.backward`` (B5
and the loss's gradient) and ``ldpc.train.update`` (the gradient mask, the
mesh sum, Adam and the clip), the update timed on the card as well, between
CUDA events on the batch's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ldpc_error_floor_tpu_torch.models.nms import NMSDecoder
from ldpc_error_floor_tpu_torch.models.weights import (Params, WeightSpec,
                                                       clip_weights,
                                                       trainable_mask)
from ldpc_error_floor_tpu_torch.parallel.mesh import (DataMesh, all_sum,
                                                      batch_constraint)
from ldpc_error_floor_tpu_torch.training.losses import multi_iteration_loss
from ldpc_error_floor_tpu_torch.utils.profiling import annotate


def make_optimizer(params: Params, lr: float = 1e-3) -> torch.optim.Adam:
    """Adam over the parameter tensors, which become leaves that require
    gradients."""
    tensors = [p.requires_grad_(True) for p in params.values() if p is not None]
    return torch.optim.Adam(tensors, lr=lr, betas=(0.9, 0.999), eps=1e-8)


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


class TrainStep:
    """One Adam step on the block [train_start, train_end):
    ``step(params, optimizer, llr, labels, etha) -> loss`` (a 0-d tensor on
    the device, detached).

    ``static_etha``: 0.0 when the configuration's eta is identically zero;
    the loss then takes its last-iteration path, and a decoder whose
    ``app_t0`` windows the APP stack is legal (its loss window shifts with
    it).

    ``mesh``: `llr` and `labels` are this rank's lanes, and the returned
    loss is the mean over the ranks."""

    def __init__(self, decoder: NMSDecoder, spec: WeightSpec, loss_type: int,
                 train_start: int, train_end: int, fixed_init: int = 0,
                 static_etha: Optional[float] = None,
                 mesh: Optional[DataMesh] = None):
        self.decoder = decoder
        self.mesh = mesh
        self.spec = spec
        self.loss_type = loss_type
        self.static_etha = static_etha
        self.masks = trainable_mask(spec, train_start, train_end, fixed_init)
        t_lo = max(train_start - fixed_init, spec.fixed_iter)
        t_off = decoder.cfg.app_t0
        if t_off and static_etha != 0.0:
            raise ValueError("an APP window (app_t0 > 0) requires the static "
                             "eta = 0 loss")
        self.t_lo = max(0, t_lo - t_off)
        self._mask_dev: Dict[torch.device, Dict[str, torch.Tensor]] = {}

    def _device_masks(self, dev: torch.device) -> Dict[str, torch.Tensor]:
        masks = self._mask_dev.get(dev)
        if masks is None:
            masks = self._mask_dev[dev] = {
                k: torch.as_tensor(v[:, None], dtype=torch.float32, device=dev)
                for k, v in self.masks.items() if v is not None}
        return masks

    def __call__(self, params: Params, optimizer: torch.optim.Optimizer,
                 llr: torch.Tensor, labels: torch.Tensor, etha) -> torch.Tensor:
        live = {k: p for k, p in params.items() if p is not None}
        for p in live.values():
            p.grad = None
        with annotate("ldpc.train.forward"):
            res = self.decoder.apply(params, llr, collect="apps")
        e = self.static_etha if self.static_etha is not None else etha
        with annotate("ldpc.train.loss"):
            loss = multi_iteration_loss(res.apps, labels, self.loss_type, e,
                                        t_start=self.t_lo)
        with annotate("ldpc.train.backward"):
            loss.backward()
        with annotate("ldpc.train.update", device=llr.device):
            masks = self._device_masks(llr.device)
            with torch.no_grad():
                for k, p in live.items():
                    if p.grad is None:  # Adam must still see the (zero) gradient
                        p.grad = torch.zeros_like(p)
                    p.grad.mul_(masks[k])
                loss = loss.detach()
                if self.mesh is not None:
                    grads = [p.grad for p in live.values()]
                    flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1)])
                    all_sum(self.mesh, flat).div_(self.mesh.world)
                    for g, v in zip(grads, flat[:-1].split([g.numel() for g in grads])):
                        g.copy_(v.view_as(g))
                    loss = flat[-1]
            optimizer.step()
            with torch.no_grad():
                clipped = clip_weights(self.spec, {k: p.detach() for k, p in live.items()},
                                       masks=masks)
                for k, p in live.items():
                    p.copy_(clipped[k])
        return loss


def make_train_step(decoder: NMSDecoder, spec: WeightSpec, loss_type: int,
                    train_start: int, train_end: int, fixed_init: int = 0,
                    static_etha: Optional[float] = None,
                    mesh: Optional[DataMesh] = None) -> TrainStep:
    """The step for the training block [train_start, train_end)."""
    return TrainStep(decoder, spec, loss_type, train_start, train_end,
                     fixed_init, static_etha, mesh)


def make_epoch_step(decoder: NMSDecoder, spec: WeightSpec, loss_type: int,
                    train_start: int, train_end: int, fixed_init: int,
                    n_steps: int, labels: torch.Tensor, channel=None,
                    sigmas: Optional[torch.Tensor] = None,
                    data_mode: bool = False, encoder=None,
                    static_etha: Optional[float] = None,
                    mesh: Optional[DataMesh] = None) -> Callable:
    """`n_steps` train steps, sampling on the device.  Under a mesh each
    rank draws (or slices) the whole global batch of ``labels.shape[-1]``
    lanes, from the generator every rank holds in the same state, and
    steps on its own lanes: a world of W trains on the numbers a world of
    one trains on.  Returns

      data_mode=False: epoch(params, optimizer, generator, etha) -> mean loss
        (mixed-SNR AWGN lanes `sigmas` [B] from the channel; with `encoder`,
        fresh random codewords and BCE against their bits);
      data_mode=True: epoch(params, optimizer, data, etha) -> mean loss,
        where data is [n_steps*B, N*z] rows on the device.

    The mean loss is a 0-d tensor on the device."""
    step = make_train_step(decoder, spec, loss_type, train_start, train_end,
                           fixed_init, static_etha, mesh)
    batch = labels.shape[-1]
    nbits = labels.shape[0]
    shard = batch_constraint(mesh)
    local_labels = shard(labels)

    def batch_of(source, i):
        if data_mode:
            return shard(source[i * batch:(i + 1) * batch].T).contiguous(), local_labels
        if encoder is None:
            return shard(channel.sample(source, sigmas)), local_labels
        bits = encoder.random_codewords(source, batch)
        return shard(channel.sample_codewords(source, sigmas, bits)), shard(bits[:nbits])

    def epoch(params: Params, optimizer: torch.optim.Optimizer, source,
              etha) -> torch.Tensor:
        losses = []
        for i in range(n_steps):
            with annotate("ldpc.train.sample"):
                llr, lab = batch_of(source, i)
            losses.append(step(params, optimizer, llr, lab, etha))
        return torch.stack(losses).mean()

    return epoch
