"""sigma-VAE trainer for the wind-field generator (the port of
ble_tpu/generative/train_vae.py; reference
generative/learn_wind_field_generator.py).

The objective is the sigma-VAE's: MSE / 2 sigma^2 + log(sigma sqrt(2 pi))
+ kl_weight * KLD (learn_wind_field_generator.py:118-135), with the
KL-weight schedules (:59-93) and the per-epoch evaluation, the
mean-wind-speed drift of free generations included (:153-200). The
network runs batch-first; the optimizer is torch.optim.Adam with optax
adam's defaults. train() draws its keys as the JAX package's train() does,
so a seed and a reservoir give the JAX package's run. A checkpoint is the
model's state dict, <checkpoint_dir>/vae_<epoch>.pt.

Run, from the root of a checkout:
  python -m ble_tpu_torch.generative.train_vae --epochs 10 --synthetic
  python -m ble_tpu_torch.generative.train_vae --device cpu --synthetic \\
      --epochs 1 --batches_per_epoch 3 --batch_size 2
"""

import argparse
import os
from typing import Callable

import numpy as np
import torch

from ble_tpu_torch import resolve_device
from ble_tpu_torch.generative import reservoir as reservoir_lib
from ble_tpu_torch.generative import vae
from ble_tpu_torch.utils import prng

# jnp.sqrt(2 * jnp.pi) in float32.
_SQRT_2PI = float(np.sqrt(np.float32(2 * np.pi)))


def constant_schedule(value: float) -> Callable[[int], float]:
  return lambda idx: value


def step_schedule(start_value: float, increment: float, frequency: int,
                  max_val: float) -> Callable[[int], float]:
  return lambda idx: min(start_value * (increment ** (idx // frequency)),
                         max_val)


def kl_divergence(mean, logvar):
  return -0.5 * torch.sum(1 + logvar - torch.square(mean) - torch.exp(logvar),
                          dim=-1)


def make_optimizer(model: vae.WindFieldVAE,
                   learning_rate: float) -> torch.optim.Optimizer:
  """optax.adam(learning_rate)'s counterpart."""
  return torch.optim.Adam(model.parameters(), lr=learning_rate,
                          betas=(0.9, 0.999), eps=1e-8)


def make_train_step(model: vae.WindFieldVAE,
                    optimizer: torch.optim.Optimizer):
  """train_step(batch, key, kl_weight) -> metrics: one sigma-VAE step of
  `model` in place (ble_tpu/generative/train_vae.py:45-63), the latent
  noise drawn from `key`. The metrics are device tensors: the loss, the
  batch means of the MSE and the KLD, and sigma, all before the update."""

  def train_step(batch, key, kl_weight: float):
    optimizer.zero_grad(set_to_none=True)
    recon, (mean, logvar), sigma = model(batch, key)
    mse = torch.sum((recon - batch) ** 2, dim=tuple(range(1, recon.dim())))
    kld = kl_divergence(mean, logvar)
    combined = (0.5 / sigma ** 2 * mse + torch.log(sigma * _SQRT_2PI) +
                float(np.float32(kl_weight)) * kld)
    loss = combined.mean()
    loss.backward()
    metrics = {'loss': loss.detach(), 'mse': mse.detach().mean(),
               'kld': kld.detach().mean(), 'sigma': sigma.detach().clone()}
    optimizer.step()
    return metrics

  return train_step


@torch.no_grad()
def evaluate(model: vae.WindFieldVAE, fields, key) -> dict:
  """Reconstruction and generation diagnostics
  (learn_wind_field_generator.py:153-200): the latent is the mean, and
  `key` draws the free generations' latents."""
  mean, logvar = model.encoder(fields)
  recon = model.decoder(mean)
  mse = torch.mean(torch.sum((recon - fields) ** 2,
                             dim=tuple(range(1, recon.dim()))))
  kld = torch.mean(kl_divergence(mean, logvar))
  z = prng.normal(key, (fields.shape[0], vae.NUM_LATENTS)).to(fields.device)
  generated = model.generate(z)
  gen_speed = torch.mean(torch.sqrt(torch.sum(generated ** 2, dim=-1)))
  data_speed = torch.mean(torch.sqrt(torch.sum(fields ** 2, dim=-1)))
  return {'eval_mse': mse, 'eval_kld': kld, 'gen_mean_speed': gen_speed,
          'data_mean_speed': data_speed,
          'sigma': model.sigma.detach().clone()}


def _epoch_line(epoch: int, metrics: dict, eval_metrics: dict) -> str:
  """The JAX package's line for an epoch: the step's metrics, then the
  evaluation's, each in sorted order (as jit returns a dict) and the
  evaluation's sigma in place of the step's."""
  merged = {**dict(sorted(metrics.items())),
            **dict(sorted(eval_metrics.items()))}
  return f'epoch {epoch}: ' + ' '.join(f'{k}={float(v):.4f}'
                                       for k, v in merged.items())


def train(reservoir: reservoir_lib.WindFieldReservoir,
          num_epochs: int = 10,
          batches_per_epoch: int = 200,
          batch_size: int = 16,
          learning_rate: float = 1e-4,
          kl_schedule: Callable[[int], float] = constant_schedule(512.0),
          checkpoint_dir: str = None,
          seed: int = 0,
          device=None) -> vae.WindFieldVAE:
  """Trains a WindFieldVAE on `device` (default cuda) and returns it. The
  keys follow ble_tpu/generative/train_vae.py:90-124: init_key, key =
  split(key(seed)); per batch key, batch_key, step_key = split(key, 3);
  per epoch key, eval_key = split(key). Prints one line an epoch: the last
  step's metrics and the evaluation's."""
  device = resolve_device(device)
  key = prng.key(seed)
  init_key, key = prng.split(key)
  model = vae.make_vae(vae.init_vae_params(init_key), device)
  train_step = make_train_step(model, make_optimizer(model, learning_rate))

  for epoch in range(num_epochs):
    kl_weight = kl_schedule(epoch)
    for _ in range(batches_per_epoch):
      key, batch_key, step_key = prng.split(key, 3)
      batch = reservoir.get_batch(batch_size, batch_key).to(device)
      metrics = train_step(batch, step_key, kl_weight)
    key, eval_key = prng.split(key)
    eval_metrics = evaluate(
        model, reservoir.get_eval_batch(batch_size).to(device), eval_key)
    print(_epoch_line(epoch, metrics, eval_metrics), flush=True)
    if checkpoint_dir:
      directory = os.path.abspath(checkpoint_dir)
      os.makedirs(directory, exist_ok=True)
      path = os.path.join(directory, f'vae_{epoch}.pt')
      torch.save(model.state_dict(), path + '.tmp')
      os.replace(path + '.tmp', path)

  return model


def main(argv=None):
  parser = argparse.ArgumentParser(description=__doc__)
  parser.add_argument('--epochs', type=int, default=10)
  parser.add_argument('--batches_per_epoch', type=int, default=200)
  parser.add_argument('--batch_size', type=int, default=16)
  parser.add_argument('--learning_rate', type=float, default=1e-4)
  parser.add_argument('--dataset_path', type=str, default=None)
  parser.add_argument('--synthetic', action='store_true')
  parser.add_argument('--checkpoint_dir', type=str, default=None)
  parser.add_argument('--device', type=str, default='cuda')
  args = parser.parse_args(argv)

  device = resolve_device(args.device)
  if args.synthetic or not args.dataset_path:
    reservoir = reservoir_lib.SyntheticWindFieldReservoir(device=device)
  else:
    reservoir = reservoir_lib.DatasetWindFieldReservoir(args.dataset_path,
                                                         device=device)

  return train(reservoir, num_epochs=args.epochs,
               batches_per_epoch=args.batches_per_epoch,
               batch_size=args.batch_size, learning_rate=args.learning_rate,
               checkpoint_dir=args.checkpoint_dir, device=device)


if __name__ == '__main__':
  main()
