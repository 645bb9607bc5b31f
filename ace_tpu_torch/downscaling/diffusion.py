"""EDM diffusion core: preconditioning, training loss and the stochastic
sampler (port of ace_tpu/downscaling/diffusion.py; Karras et al. 2022).

A denoiser is ``(x [B, H, W, C], condition [B, H, W, Cc], sigma)`` ->
denoised, where ``sigma`` is a ``[B]`` tensor or a host float (one noise
level for the batch, as the sampler passes it). The sampler is a Python
loop over the static Heun schedule: its noise levels are float32 host
scalars computed as ``ace_tpu`` computes them, so nothing in the loop
waits for the device, and a mixture of experts routes on the host.

Random draws come from an explicit ``torch.Generator``; the loss and the
sampler also take pre-drawn ``sigma``/``noise``, ``latents`` and ``eps``
(standard normals), so that a test can pass in ``ace_tpu``'s draws.
"""

import dataclasses
import math
from typing import Callable

import numpy as np
import torch

DenoiserFn = Callable[..., torch.Tensor]


def _sigma_tensor(sigma, x: torch.Tensor) -> torch.Tensor:
    """``sigma`` as a float32 ``[B]`` tensor on ``x``'s device (a host
    float is filled in, without waiting for the device)."""
    if isinstance(sigma, torch.Tensor):
        return sigma.reshape(-1).float()
    return torch.full((x.shape[0],), float(sigma), dtype=torch.float32,
                      device=x.device)


def edm_precondition(raw_net, sigma_data: float = 0.5) -> DenoiserFn:
    """The EDM denoiser ``D(x; sigma) = c_skip x + c_out F(c_in x,
    c_noise)`` around the raw network ``raw_net(x, condition, c_noise)``."""

    def denoiser(x, condition, sigma):
        sigma = _sigma_tensor(sigma, x)
        c_noise = torch.log(sigma) / 4.0
        sigma = sigma.reshape((-1,) + (1,) * (x.dim() - 1))
        s2 = sigma_data ** 2
        c_skip = s2 / (sigma ** 2 + s2)
        c_out = sigma * sigma_data / torch.sqrt(sigma ** 2 + s2)
        c_in = 1.0 / torch.sqrt(s2 + sigma ** 2)
        f = raw_net(c_in * x, condition, c_noise)
        return c_skip * x + c_out * f

    return denoiser


def validate_sigma_ranges(sigma_ranges) -> None:
    """Sorted, non-empty, contiguous ``[min, max]`` ranges."""
    if not sigma_ranges:
        raise ValueError("sigma_ranges must contain at least one entry.")
    for s_min, s_max in sigma_ranges:
        if s_min >= s_max:
            raise ValueError(
                f"Each range needs sigma_min < sigma_max; got "
                f"[{s_min}, {s_max}]."
            )
    for i in range(len(sigma_ranges) - 1):
        if sigma_ranges[i][0] >= sigma_ranges[i + 1][0]:
            raise ValueError(
                "sigma_ranges must be sorted by sigma_min ascending."
            )
        if sigma_ranges[i][1] != sigma_ranges[i + 1][0]:
            raise ValueError(
                "Sigma ranges must be contiguous: "
                f"sigma_ranges[{i}] max ({sigma_ranges[i][1]}) must equal "
                f"sigma_ranges[{i + 1}] min ({sigma_ranges[i + 1][0]})."
            )


def expert_index(sigma: float, sigma_ranges) -> int:
    """The expert whose inclusive range holds ``sigma``: at a shared
    boundary the lower-noise expert, outside every range the nearest
    boundary expert (``ace_tpu``'s count of upper bounds below sigma, in
    float32)."""
    s = np.float32(sigma)
    return int(sum(s > np.float32(hi) for _, hi in sigma_ranges[:-1]))


def make_moe_denoiser(sigma_ranges, denoisers) -> DenoiserFn:
    """A mixture of experts: each call routes to the expert whose sigma
    range holds the batch's noise level, a host float (the sampler's)."""
    validate_sigma_ranges(sigma_ranges)
    if len(sigma_ranges) != len(denoisers):
        raise ValueError(
            "sigma_ranges and denoisers must have the same length."
        )
    if len(denoisers) == 1:
        return denoisers[0]

    def denoiser(x, condition, sigma):
        if isinstance(sigma, torch.Tensor):
            raise TypeError("the mixture of experts routes on a host float "
                            "sigma (one noise level for the batch)")
        return denoisers[expert_index(sigma, sigma_ranges)](x, condition,
                                                            sigma)

    return denoiser


@dataclasses.dataclass
class LogNormalNoiseDistribution:
    """sigma ~ exp(N(p_mean, p_std))."""

    p_mean: float = -1.2
    p_std: float = 1.2

    def sample(self, generator, shape, device=None):
        z = torch.randn(shape, generator=generator, device=device)
        return torch.exp(self.p_mean + self.p_std * z)


@dataclasses.dataclass
class LogUniformNoiseDistribution:
    sigma_min: float = 0.002
    sigma_max: float = 80.0

    def sample(self, generator, shape, device=None):
        lo, hi = math.log(self.sigma_min), math.log(self.sigma_max)
        u = torch.rand(shape, generator=generator, device=device)
        return torch.exp(lo + (hi - lo) * u)


def edm_loss(denoiser: DenoiserFn, target, condition, generator=None,
             noise_distribution=None, sigma_data: float = 0.5,
             loss_weight_exponent: float = 1.0, channel_weights=None,
             sigma=None, noise=None):
    """The EDM denoising score-matching loss (Karras et al. eq. 8), with
    the noise level's weight raised to ``loss_weight_exponent`` and
    optional per-channel weights. ``sigma`` ``[B]`` and ``noise`` (standard
    normals of ``target``'s shape) are drawn from ``generator`` unless
    given."""
    if noise_distribution is None:
        noise_distribution = LogNormalNoiseDistribution()
    if sigma is None:
        sigma = noise_distribution.sample(generator, (target.shape[0],),
                                          target.device)
    if noise is None:
        noise = torch.randn(target.shape, generator=generator,
                            device=target.device)
    sigma_b = sigma.reshape((-1,) + (1,) * (target.dim() - 1))
    weight = ((sigma_b ** 2 + sigma_data ** 2)
              / (sigma_b * sigma_data) ** 2) ** loss_weight_exponent
    denoised = denoiser(target + noise * sigma_b, condition, sigma)
    err = weight * (denoised - target) ** 2
    if channel_weights is not None:
        # copied without waiting for the device
        err = err * torch.tensor(channel_weights, dtype=err.dtype).to(
            err.device, non_blocking=True)
    return err.mean()


def karras_schedule(num_steps: int, sigma_min: float, sigma_max: float,
                    rho: float = 7.0) -> np.ndarray:
    """The ``num_steps + 1`` noise levels of the Heun schedule (the last
    0), in float32 as ``ace_tpu`` computes them."""
    f32 = np.float32
    i = np.arange(num_steps, dtype=f32)
    hi, lo = f32(sigma_max ** (1 / rho)), f32(sigma_min ** (1 / rho))
    t = (hi + i / f32(num_steps - 1) * (lo - hi)) ** f32(rho)
    return np.concatenate([t.astype(f32), np.zeros(1, f32)])


def stochastic_sampler(denoiser: DenoiserFn, latents: torch.Tensor,
                       condition: torch.Tensor, generator=None,
                       num_steps: int = 18, sigma_min: float = 0.002,
                       sigma_max: float = 80.0, rho: float = 7.0,
                       S_churn: float = 0.0, S_min: float = 0.0,
                       S_max: float = float("inf"), S_noise: float = 1.0,
                       eps=None) -> torch.Tensor:
    """EDM Algorithm 2: Heun steps with optional churn, no second
    evaluation on the last step (to sigma 0): ``2 num_steps - 1`` calls of
    the denoiser. ``latents`` are N(0, 1) of the output's shape; ``eps``
    (a list of one standard normal per step, or None) is the churn's
    noise, drawn from ``generator`` where a step churns."""
    f32 = np.float32
    t_steps = karras_schedule(num_steps, sigma_min, sigma_max, rho)
    gamma_base = f32(min(S_churn / num_steps, 2 ** 0.5 - 1))
    x = latents * float(t_steps[0])
    for idx in range(num_steps):
        t_cur, t_next = t_steps[idx], t_steps[idx + 1]
        gamma = gamma_base if S_min <= t_cur <= S_max else f32(0.0)
        t_hat = f32(t_cur * (f32(1.0) + gamma))
        spread = f32(np.sqrt(max(f32(t_hat * t_hat - t_cur * t_cur),
                                 f32(0.0))))
        if spread > 0:
            e = (eps[idx] if eps is not None else torch.randn(
                x.shape, generator=generator, device=x.device))
            x_hat = x + float(spread) * (e * S_noise)
        else:
            x_hat = x
        denoised = denoiser(x_hat, condition, float(t_hat))
        d_cur = (x_hat - denoised) / float(t_hat)
        x_next = x_hat + float(f32(t_next - t_hat)) * d_cur
        if idx < num_steps - 1:
            denoised2 = denoiser(x_next, condition, float(t_next))
            d_prime = (x_next - denoised2) / float(t_next)
            coef = f32(f32(t_next - t_hat) * f32(0.5))
            x_next = x_hat + float(coef) * (d_cur + d_prime)
        x = x_next
    return x
