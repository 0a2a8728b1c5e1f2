"""Tiled MultiDiffusion inpainting engine (image-space DDPM/DDIM).

Structural rebuild of the reference ``SatDiffEngine``
(``members/marcin/models/satdiff.py``): the part worth owning is not the
pretrained Stable-Diffusion weights (which the reference downloads from HF,
``satdiff.py:90-121``) but the **tiled MultiDiffusion sampler**
(``tiled_inpaint`` ``:139-233``): tiles with stride < size, Gaussian blend
weights, per-step fusion of tile noise predictions, and re-noising of the
unmasked region to lock known content.

Accelerator form: the timestep loop is a ``lax.scan``; all tiles are ONE
vmapped epsilon-model batch per step (the reference loops tiles in Python,
``:184-216``); blending is a scatter-add with precomputed Gaussian weights.
The epsilon model is pluggable — any ``apply(params, x_t, t, cond) -> eps``;
a compact conditioned U-Net (:class:`CondUNet`) ships for training from
scratch, and the engine runs in image space (no VAE — the reference's
latent tiling maps 1:1 onto image tiling here).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from flax import linen as nn

from pcmi_tpu.models.unet import ConvBlock, _down, _up


MAX_PROMPT_TOKENS = 8
TOKEN_HASH_BUCKETS = 512


def tokenize_prompt(prompt: str | None,
                    max_tokens: int = MAX_PROMPT_TOKENS) -> np.ndarray:
    """Hash-tokenise a free-text prompt into (max_tokens,) int32 ids.

    Word tokens hash into ``TOKEN_HASH_BUCKETS - 1`` buckets (id 0 is the
    pad/null token, so an empty prompt IS the unconditional embedding).
    Hashing is FNV-1a over the lowercased word — stable across processes
    (unlike Python's salted ``hash``), so checkpoints keep meaning.
    """
    ids = np.zeros((max_tokens,), np.int32)
    if not prompt:
        return ids
    words = str(prompt).lower().split()
    for i, wd in enumerate(words[:max_tokens]):
        acc = 2166136261
        for ch in wd.encode():
            acc = ((acc ^ ch) * 16777619) & 0xFFFFFFFF
        ids[i] = acc % (TOKEN_HASH_BUCKETS - 1) + 1
    return ids


class TextEncoder(nn.Module):
    """Tiny trained-from-scratch prompt encoder: hashed word embeddings →
    order-aware 1D conv mixing → masked mean-pool → conditioning vector.

    The honest in-framework analogue of the reference's CLIP text encoder
    (``stan/plugin.py:156-170``): compositional (multi-word prompts
    combine), graded (classifier-free guidance scales its influence), and
    trained jointly with the epsilon model on caption-labelled scenes —
    without pretrained weights, which this environment cannot download.
    """

    dim: int = 32

    @nn.compact
    def __call__(self, tokens):           # (B, L) int32, 0 = pad
        emb = nn.Embed(TOKEN_HASH_BUCKETS, self.dim)(tokens)
        mask = (tokens > 0)[..., None].astype(emb.dtype)
        h = nn.Conv(self.dim, (3,))(emb * mask)
        h = nn.gelu(h)
        pooled = (h * mask).sum(1) / jnp.maximum(mask.sum(1), 1.0)
        return nn.Dense(self.dim)(pooled)


class CondUNet(nn.Module):
    """Small epsilon-model: input (B, T, T, C_img*2+1) = x_t ++ masked ++ mask,
    plus a sinusoidal timestep embedding added per level.

    Two semantic conditioning surfaces (the analogue of the reference's
    text-prompt control, per-task prompts ``satdiff.py:24-55``, user
    prompt/negative-prompt ``stan/plugin.py:156-170``):

    * ``n_classes > 0`` — a learned class embedding (fixed vocabulary);
    * ``text_conditioning`` — a jointly-trained :class:`TextEncoder` over
      hashed free-text tokens (compositional multi-word prompts; all-pad
      tokens = the unconditional branch for classifier-free guidance).
    """

    widths: tuple = (32, 64, 128)
    out_channels: int = 3
    n_classes: int = 0
    text_conditioning: bool = False

    @nn.compact
    def __call__(self, x_t, t, cond, class_id=None, tokens=None):
        # t: (B,) in [0, 1); sinusoidal features broadcast over space
        freqs = jnp.exp(jnp.linspace(0.0, 6.0, 16))
        temb = jnp.concatenate(
            [jnp.sin(t[:, None] * freqs), jnp.cos(t[:, None] * freqs)], axis=1
        )  # (B, 32)
        if self.n_classes:
            cid = (jnp.zeros(t.shape, jnp.int32)
                   if class_id is None else class_id)
            temb = temb + nn.Embed(self.n_classes, 32)(cid)
        if self.text_conditioning:
            tok = (jnp.zeros((x_t.shape[0], MAX_PROMPT_TOKENS), jnp.int32)
                   if tokens is None else tokens)
            temb = temb + TextEncoder(dim=32)(tok)
        h = jnp.concatenate([x_t, cond], axis=-1)
        skips = []
        for wdt in self.widths[:-1]:
            h = ConvBlock(wdt)(h)
            h = h + nn.Dense(wdt)(temb)[:, None, None, :]
            skips.append(h)
            h = _down(h)
        h = ConvBlock(self.widths[-1])(h)
        h = h + nn.Dense(self.widths[-1])(temb)[:, None, None, :]
        for wdt, skip in zip(reversed(self.widths[:-1]), reversed(skips)):
            h = _up(h, wdt)
            h = jnp.concatenate([h, skip], axis=-1)
            h = ConvBlock(wdt)(h)
        return nn.Conv(self.out_channels, (1, 1))(h)


@dataclasses.dataclass(frozen=True)
class DiffusionConfig:
    steps: int = 27               # ref 25-30 DPM++ steps (satdiff.py:24-55)
    train_timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    tile: int = 64                # ref 64-latent tiles (satdiff.py:68-80)
    stride: int = 48              # ref stride 48
    img_channels: int = 3
    # ControlNet-canny analogue (ref ``make_canny`` ``satdiff.py:123-129``):
    # a Sobel edge map of the known region (zeroed inside the hole) joins
    # the conditioning stack so structure continues across the fill
    edge_conditioning: bool = False
    # Semantic class conditioning (the prompt-control analogue, see
    # CondUNet): names index the learned class embedding; prompts map to
    # the first vocabulary name they contain (class_for_prompt)
    class_names: tuple = ()
    # Free-text conditioning via the jointly-trained TextEncoder over
    # hashed prompt tokens (multi-word compositional prompts; the empty
    # prompt is the unconditional branch). Supersedes class_names as the
    # prompt surface; both may be active.
    text_conditioning: bool = False
    # Classifier-free guidance: probability of dropping the semantic
    # conditioning during training (class -> 0, tokens -> pad), and the
    # default guidance scale at sampling (1 = plain conditional).
    cfg_dropout: float = 0.1
    guidance: float = 1.0


class Schedule(NamedTuple):
    alphas_bar: jnp.ndarray       # (T,) cumulative products


def make_schedule(cfg: DiffusionConfig) -> Schedule:
    betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.train_timesteps)
    return Schedule(alphas_bar=jnp.asarray(np.cumprod(1.0 - betas), jnp.float32))


def karras_sigmas(cfg: DiffusionConfig, steps: int, rho: float = 7.0):
    """Karras et al. sigma schedule mapped onto the VP training grid.

    The reference samples with a DPM++ *Karras* scheduler
    (``satdiff.py:97``): sigmas are spaced by ``sigma^(1/rho)`` between the
    schedule's extremes, which concentrates steps where curvature is high.
    Returns ``(sigmas[steps+1], t_indices[steps])`` — per-step sigma plus
    the nearest trained timestep for conditioning the epsilon model.
    """
    # pure-numpy twin of make_schedule (callable from inside jit tracing)
    betas = np.linspace(cfg.beta_start, cfg.beta_end, cfg.train_timesteps)
    ab = np.cumprod(1.0 - betas).astype(np.float64)
    sig_grid = np.sqrt((1.0 - ab) / ab)                  # VP sigma(t)
    s_min, s_max = float(sig_grid[0]), float(sig_grid[-1])
    ramp = np.linspace(0.0, 1.0, steps)
    sigmas = (s_max ** (1 / rho) + ramp * (s_min ** (1 / rho) - s_max ** (1 / rho))) ** rho
    t_idx = np.abs(sig_grid[None, :] - sigmas[:, None]).argmin(axis=1)
    sigmas = np.concatenate([sigmas, [0.0]])
    return (jnp.asarray(sigmas, jnp.float32),
            jnp.asarray(t_idx, jnp.int32))


def sobel_edges(img: jnp.ndarray, mask: jnp.ndarray) -> jnp.ndarray:
    """Per-pixel Sobel gradient magnitude of the known region, hole zeroed
    (the reference's canny control image, ``satdiff.py:123-129``)."""
    mono = img.mean(axis=-1, keepdims=True) if img.ndim == 3 else img[..., None]
    m = mono[..., 0]
    gx = (jnp.roll(m, -1, 1) - jnp.roll(m, 1, 1)
          + 0.5 * (jnp.roll(jnp.roll(m, -1, 1), 1, 0) - jnp.roll(jnp.roll(m, 1, 1), 1, 0))
          + 0.5 * (jnp.roll(jnp.roll(m, -1, 1), -1, 0) - jnp.roll(jnp.roll(m, 1, 1), -1, 0)))
    gy = (jnp.roll(m, -1, 0) - jnp.roll(m, 1, 0)
          + 0.5 * (jnp.roll(jnp.roll(m, -1, 0), 1, 1) - jnp.roll(jnp.roll(m, 1, 0), 1, 1))
          + 0.5 * (jnp.roll(jnp.roll(m, -1, 0), -1, 1) - jnp.roll(jnp.roll(m, 1, 0), -1, 1)))
    edges = jnp.hypot(gx, gy)[..., None]
    return edges * (1.0 - mask)


def _cond_stack(cfg: DiffusionConfig, image: jnp.ndarray, mask: jnp.ndarray):
    parts = [image * (1 - mask), mask]
    if cfg.edge_conditioning:
        parts.append(sobel_edges(image, mask))
    return jnp.concatenate(parts, axis=-1)


def gaussian_weights(tile: int) -> jnp.ndarray:
    """Per-tile blend weights (ref ``gaussian_weights`` ``satdiff.py:58-65``)."""
    x = np.arange(tile) - (tile - 1) / 2
    g = np.exp(-(x**2) / (2 * (tile / 4) ** 2))
    return jnp.asarray(np.outer(g, g), jnp.float32)[..., None]


def tile_origins(size: int, tile: int, stride: int):
    """Origins covering ``size`` (ref ``get_tiles`` ``satdiff.py:68-80``)."""
    if size <= tile:
        return [0]
    out = list(range(0, size - tile, stride))
    out.append(size - tile)
    return out


class TiledDiffusionEngine:
    """MultiDiffusion inpainting over arbitrarily large canvases."""

    def __init__(self, cfg: DiffusionConfig = DiffusionConfig(),
                 model: nn.Module | None = None):
        self.cfg = cfg
        self.model = model or CondUNet(
            out_channels=cfg.img_channels,
            n_classes=len(cfg.class_names),
            text_conditioning=cfg.text_conditioning,
        )
        self.schedule = make_schedule(cfg)

    def class_for_prompt(self, prompt) -> jnp.ndarray:
        """Map a prompt string (or class index) onto the class vocabulary
        — the stand-in for the reference's text encoder: the first
        vocabulary name contained in the prompt wins; unknown prompts get
        class 0 (the unconditional/default slot by convention)."""
        if isinstance(prompt, (int, np.integer)):
            return jnp.asarray(int(prompt), jnp.int32)
        if prompt:
            low = str(prompt).lower()
            for k, name in enumerate(self.cfg.class_names):
                if name.lower() in low:
                    return jnp.asarray(k, jnp.int32)
        return jnp.asarray(0, jnp.int32)

    def tokens_for_prompt(self, prompt) -> jnp.ndarray | None:
        if not self.cfg.text_conditioning:
            return None
        return jnp.asarray(tokenize_prompt(prompt), jnp.int32)

    def init_params(self, key: jax.Array):
        c = self.cfg.img_channels
        cond_ch = c + 1 + (1 if self.cfg.edge_conditioning else 0)
        x = jnp.zeros((1, self.cfg.tile, self.cfg.tile, c))
        cond = jnp.zeros((1, self.cfg.tile, self.cfg.tile, cond_ch))
        cid = jnp.zeros((1,), jnp.int32) if self.cfg.class_names else None
        tok = (jnp.zeros((1, MAX_PROMPT_TOKENS), jnp.int32)
               if self.cfg.text_conditioning else None)
        return self.model.init(key, x, jnp.zeros((1,)), cond, cid, tok)

    @partial(jax.jit, static_argnames=("self",))
    def train_step_loss(self, params, images, masks, key, class_ids=None,
                        tokens=None):
        """Denoising score-matching loss for the conditioned eps-model.

        With ``cfg.cfg_dropout > 0`` the semantic conditioning (class id
        and/or prompt tokens) is dropped per-sample to the unconditional
        branch — the classifier-free-guidance training recipe (Ho &
        Salimans 2022), matching the reference's guidance-scale surface
        (``stan/plugin.py:156-170``).
        """
        cfg = self.cfg
        b = images.shape[0]
        kt, kn, kd = jax.random.split(key, 3)
        t_idx = jax.random.randint(kt, (b,), 0, cfg.train_timesteps)
        ab = self.schedule.alphas_bar[t_idx][:, None, None, None]
        noise = jax.random.normal(kn, images.shape)
        x_t = jnp.sqrt(ab) * images + jnp.sqrt(1 - ab) * noise
        cond = jax.vmap(lambda im, mk: _cond_stack(cfg, im, mk))(images, masks)
        if cfg.cfg_dropout > 0 and (class_ids is not None or tokens is not None):
            drop = jax.random.bernoulli(kd, cfg.cfg_dropout, (b,))
            if class_ids is not None:
                class_ids = jnp.where(drop, 0, class_ids)
            if tokens is not None:
                tokens = jnp.where(drop[:, None],
                                   jnp.zeros_like(tokens), tokens)
        eps = self.model.apply(params, x_t,
                               t_idx.astype(jnp.float32) / cfg.train_timesteps,
                               cond, class_ids, tokens)
        return jnp.mean((eps - noise) ** 2)

    def _tiler(self, canvas):
        """(slice_tiles, blend_tiles) over the MultiDiffusion tile grid."""
        cfg = self.cfg
        h, w = canvas
        oy = tile_origins(h, cfg.tile, cfg.stride)
        ox = tile_origins(w, cfg.tile, cfg.stride)
        origins = jnp.asarray([(y, x) for y in oy for x in ox], jnp.int32)
        wts = gaussian_weights(cfg.tile)

        norm = jnp.zeros((h, w, 1))
        for y in oy:
            for x in ox:
                norm = jax.lax.dynamic_update_slice(
                    norm,
                    jax.lax.dynamic_slice(norm, (y, x, 0), (cfg.tile, cfg.tile, 1)) + wts,
                    (y, x, 0),
                )

        def slice_tiles(full):
            def one(o):
                return jax.lax.dynamic_slice(
                    full, (o[0], o[1], 0), (cfg.tile, cfg.tile, full.shape[-1]))
            return jax.vmap(one)(origins)

        def blend_tiles(tiles):
            def body(i, acc):
                o = origins[i]
                cur = jax.lax.dynamic_slice(
                    acc, (o[0], o[1], 0), (cfg.tile, cfg.tile, tiles.shape[-1]))
                return jax.lax.dynamic_update_slice(
                    acc, cur + tiles[i] * wts, (o[0], o[1], 0))
            acc = jnp.zeros((h, w, tiles.shape[-1]))
            return jax.lax.fori_loop(0, tiles.shape[0], body, acc) / norm

        return slice_tiles, blend_tiles

    def _eps_fn(self, params, slice_tiles, blend_tiles, cond_full,
                class_id, tokens, neg_tokens, guidance: float):
        """Blended epsilon over the tile grid, with classifier-free
        guidance when ``guidance != 1``: conditional and unconditional
        (or negative-prompt) tile batches run as ONE stacked model apply,
        and ``eps = eps_u + g * (eps_c - eps_u)`` — a negative prompt
        replaces the unconditional branch, the standard CFG surface
        (ref prompt/negative_prompt/guidance, ``stan/plugin.py:156-170``).
        ``guidance`` is static: at 1.0 the plain single-batch path traces.
        """
        cfg = self.cfg
        has_sem = class_id is not None or tokens is not None
        use_cfg = (guidance != 1.0 or neg_tokens is not None) and has_sem

        def eps_of(x, t01):
            tiles_x = slice_tiles(x)
            tiles_c = slice_tiles(cond_full)
            n = tiles_x.shape[0]
            tvec = jnp.full((n,), t01)
            cid = (None if class_id is None
                   else jnp.full((n,), class_id, jnp.int32))
            tok = None if tokens is None else jnp.tile(tokens[None], (n, 1))
            if not use_cfg:
                return blend_tiles(
                    self.model.apply(params, tiles_x, tvec, tiles_c, cid, tok))
            u_tok = None
            if tokens is not None:
                base = (jnp.zeros_like(tokens) if neg_tokens is None
                        else neg_tokens)
                u_tok = jnp.tile(base[None], (n, 1))
            x2 = jnp.concatenate([tiles_x, tiles_x])
            c2 = jnp.concatenate([tiles_c, tiles_c])
            t2 = jnp.concatenate([tvec, tvec])
            cid2 = (None if cid is None
                    else jnp.concatenate([cid, jnp.zeros_like(cid)]))
            tok2 = (None if tok is None
                    else jnp.concatenate([tok, u_tok]))
            out = self.model.apply(params, x2, t2, c2, cid2, tok2)
            e_c, e_u = out[:n], out[n:]
            return blend_tiles(e_u + guidance * (e_c - e_u))

        return eps_of

    @partial(jax.jit, static_argnames=("self", "canvas", "guidance"))
    def _sample(self, params, image, mask, key, canvas, class_id=None,
                tokens=None, neg_tokens=None, guidance: float = 1.0):
        """DDIM sampling with tiled eps evaluation + known-region locking."""
        cfg = self.cfg
        h, w = canvas
        slice_tiles, blend_tiles = self._tiler(canvas)
        cond_full = _cond_stack(cfg, image, mask)
        eps_of = self._eps_fn(params, slice_tiles, blend_tiles, cond_full,
                              class_id, tokens, neg_tokens, guidance)
        t_steps = jnp.linspace(cfg.train_timesteps - 1, 0, cfg.steps).astype(jnp.int32)

        k0, kloop = jax.random.split(key)
        x = jax.random.normal(k0, (h, w, cfg.img_channels))

        def step(carry, inp):
            x, k = carry
            t_cur, t_next = inp
            ab_t = self.schedule.alphas_bar[t_cur]
            ab_n = jnp.where(t_next >= 0, self.schedule.alphas_bar[t_next], 1.0)

            eps = eps_of(x, t_cur.astype(jnp.float32) / cfg.train_timesteps)

            x0 = (x - jnp.sqrt(1 - ab_t) * eps) / jnp.sqrt(ab_t)
            x0 = jnp.clip(x0, -2.0, 2.0)
            x_next = jnp.sqrt(ab_n) * x0 + jnp.sqrt(1 - ab_n) * eps

            # lock known region: re-noise the original to t_next
            # (ref satdiff.py:222-229)
            k, kn = jax.random.split(k)
            noise = jax.random.normal(kn, x.shape)
            known_t = jnp.sqrt(ab_n) * image + jnp.sqrt(1 - ab_n) * noise
            x_next = jnp.where(mask > 0.5, x_next, known_t)
            return (x_next, k), None

        pairs = jnp.stack([t_steps, jnp.concatenate([t_steps[1:], jnp.array([-1])])],
                          axis=1)
        (x, _), _ = jax.lax.scan(step, (x, kloop), pairs)
        return jnp.where(mask > 0.5, x, image)

    @partial(jax.jit, static_argnames=("self", "canvas", "guidance"))
    def _sample_dpmpp(self, params, image, mask, key, canvas, class_id=None,
                      tokens=None, neg_tokens=None, guidance: float = 1.0):
        """DPM-Solver++(2M) with Karras sigmas (the reference's scheduler,
        ``satdiff.py:97``), tiled eps evaluation + known-region locking.

        Works in the sigma-space variable ``x_sig = x0 + sigma*eps``; the
        VP-trained epsilon model is queried at the nearest trained timestep
        with the matching VP scaling.
        """
        cfg = self.cfg
        h, w = canvas
        slice_tiles, blend_tiles = self._tiler(canvas)
        cond_full = _cond_stack(cfg, image, mask)
        eps_of = self._eps_fn(params, slice_tiles, blend_tiles, cond_full,
                              class_id, tokens, neg_tokens, guidance)
        sigmas, t_idx = karras_sigmas(cfg, cfg.steps)
        ab = self.schedule.alphas_bar

        def eps_at(x_sig, ti):
            # exact VP view of the sigma-space state:
            # sqrt(ab)*(x0 + sigma*eps) = sqrt(ab)*x0 + sqrt(1-ab)*eps
            x_vp = x_sig * jnp.sqrt(ab[ti])
            return eps_of(x_vp, ti.astype(jnp.float32) / cfg.train_timesteps)

        k0, kloop = jax.random.split(key)
        x = jax.random.normal(k0, (h, w, cfg.img_channels)) * sigmas[0]

        def step(carry, i):
            x, old_denoised, k = carry
            sig, sig_next = sigmas[i], sigmas[i + 1]
            ti = t_idx[i]
            denoised = x - sig * eps_at(x, ti)
            t_cur = -jnp.log(jnp.maximum(sig, 1e-8))
            t_next = -jnp.log(jnp.maximum(sig_next, 1e-8))
            h_step = t_next - t_cur
            # 2M multistep correction (skipped on the first step and when
            # the previous h is unavailable)
            prev_sig = sigmas[jnp.maximum(i - 1, 0)]
            h_last = t_cur + jnp.log(jnp.maximum(prev_sig, 1e-8))
            r = h_last / jnp.where(h_step == 0, 1e-8, h_step)
            use_2m = (i > 0) & (sig_next > 0)
            d = jnp.where(
                use_2m,
                (1 + 1 / (2 * jnp.maximum(r, 1e-6))) * denoised
                - (1 / (2 * jnp.maximum(r, 1e-6))) * old_denoised,
                denoised,
            )
            x_new = (sig_next / jnp.maximum(sig, 1e-8)) * x \
                - jnp.expm1(-h_step) * d
            x_new = jnp.where(sig_next > 0, x_new, denoised)
            # lock known region at the new noise level (ref :222-229)
            k, kn = jax.random.split(k)
            known = image + sig_next * jax.random.normal(kn, x.shape)
            x_new = jnp.where(mask > 0.5, x_new, known)
            return (x_new, denoised, k), None

        (x, _, _), _ = jax.lax.scan(
            step, (x, jnp.zeros_like(x), kloop), jnp.arange(cfg.steps))
        return jnp.where(mask > 0.5, x, image)

    def inpaint(self, params, image: jnp.ndarray, mask: jnp.ndarray,
                seed: int = 0, method: str = "dpmpp",
                prompt=None, negative_prompt=None,
                guidance: float | None = None) -> jnp.ndarray:
        """image (H, W, C) in [-1, 1]-ish range; mask (H, W, 1), 1 = hole.

        ``method``: ``"dpmpp"`` (DPM-Solver++ 2M, Karras sigmas — reference
        default) or ``"ddim"``. Canvases smaller than the tile are padded
        (edge) and cropped back — slicing would otherwise fail.

        The prompt surface mirrors the reference widget
        (``stan/plugin.py:156-170``): ``prompt`` conditions the fill
        (free text with ``cfg.text_conditioning``, else class-vocabulary
        lookup), ``negative_prompt`` steers away (CFG branch), and
        ``guidance`` scales the conditioning (default ``cfg.guidance``;
        1 = plain conditional sampling).
        """
        h, w = image.shape[:2]
        ph = max(self.cfg.tile - h, 0)
        pw = max(self.cfg.tile - w, 0)
        img = image
        msk = mask
        if ph or pw:
            img = jnp.pad(img, ((0, ph), (0, pw), (0, 0)), mode="edge")
            msk = jnp.pad(msk, ((0, ph), (0, pw), (0, 0)))
        fn = self._sample_dpmpp if method == "dpmpp" else self._sample
        cid = (self.class_for_prompt(prompt) if self.cfg.class_names
               else None)
        tok = self.tokens_for_prompt(prompt)
        ntok = (self.tokens_for_prompt(negative_prompt)
                if negative_prompt and self.cfg.text_conditioning else None)
        g = float(self.cfg.guidance if guidance is None else guidance)
        out = fn(params, img, msk, jax.random.PRNGKey(seed),
                 canvas=img.shape[:2], class_id=cid, tokens=tok,
                 neg_tokens=ntok, guidance=g)
        return out[:h, :w]

    # ------------------------------------------------------------------
    # duck-typed generative-engine surface (restore/stitch/enhance),
    # matching DIPEngine so the processors accept either engine
    # ------------------------------------------------------------------

    _params = None

    def _ensure_params(self):
        if self._params is None:
            import logging

            logging.getLogger("pcmi_tpu").warning(
                "TiledDiffusionEngine running with freshly-initialised "
                "weights — train or load a checkpoint for real quality"
            )
            self._params = self.init_params(jax.random.PRNGKey(0))
        return self._params

    def load_params(self, params):
        self._params = params

    def _duck(self, image, mask, seed=0, prompt=None, **_ignored):
        from pcmi_tpu.models.dip import DIPResult

        params = self._ensure_params()
        img = jnp.asarray(image, jnp.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        if img.shape[-1] != self.cfg.img_channels:
            img = jnp.repeat(img[..., :1], self.cfg.img_channels, axis=-1)
        m = jnp.asarray(mask, jnp.float32)
        m = m[..., None] if m.ndim == 2 else m[..., :1]
        x = img * 2.0 - 1.0            # processors use [0, 1]
        out = self.inpaint(params, x, m, seed=seed, prompt=prompt)
        out = jnp.clip((out + 1.0) * 0.5, 0.0, 1.0)
        if squeeze:
            out = out[..., 0]
        elif out.shape[-1] != jnp.asarray(image).shape[-1]:
            out = out[..., 0]
        return DIPResult(output=out, losses=jnp.zeros((0,)))

    restore = _duck
    stitch = _duck

    def enhance(self, image, mask=None, seed: int = 0, strength: float = 0.3):
        """img2img: partially noise the whole frame and denoise conditioned
        on the original (mask channel 0 = 'known' — in-distribution for the
        trained epsilon model), the diffusion analogue of the reference's
        full-frame enhancement."""
        from pcmi_tpu.models.dip import DIPResult

        params = self._ensure_params()
        img = jnp.asarray(image, jnp.float32)
        squeeze = img.ndim == 2
        if squeeze:
            img = img[..., None]
        if img.shape[-1] != self.cfg.img_channels:
            img = jnp.repeat(img[..., :1], self.cfg.img_channels, axis=-1)
        x = img * 2.0 - 1.0
        out = self._img2img(params, x, jax.random.PRNGKey(seed),
                            canvas=x.shape[:2], strength=strength)
        out = jnp.clip((out + 1.0) * 0.5, 0.0, 1.0)
        if squeeze:
            out = out[..., 0]
        return DIPResult(output=out, losses=jnp.zeros((0,)))

    @partial(jax.jit, static_argnames=("self", "canvas", "strength"))
    def _img2img(self, params, image, key, canvas, strength=0.3):
        cfg = self.cfg
        h, w = canvas
        ph = max(cfg.tile - h, 0)
        pw = max(cfg.tile - w, 0)
        if ph or pw:
            image = jnp.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")
        hh, ww = image.shape[:2]
        slice_tiles, blend_tiles = self._tiler((hh, ww))
        zero_mask = jnp.zeros((hh, ww, 1))
        cond_full = _cond_stack(cfg, image, zero_mask)

        t0 = int(cfg.train_timesteps * strength)
        n_steps = max(2, int(cfg.steps * strength))
        t_steps = jnp.linspace(t0 - 1, 0, n_steps).astype(jnp.int32)
        k0, kloop = jax.random.split(key)
        ab0 = self.schedule.alphas_bar[t0 - 1]
        x = jnp.sqrt(ab0) * image + jnp.sqrt(1 - ab0) * jax.random.normal(
            k0, image.shape)

        def step(carry, inp):
            x, k = carry
            t_cur, t_next = inp
            ab_t = self.schedule.alphas_bar[t_cur]
            ab_n = jnp.where(t_next >= 0, self.schedule.alphas_bar[t_next], 1.0)
            tiles_x = slice_tiles(x)
            tiles_c = slice_tiles(cond_full)
            tvec = jnp.full((tiles_x.shape[0],),
                            t_cur.astype(jnp.float32) / cfg.train_timesteps)
            eps = blend_tiles(self.model.apply(params, tiles_x, tvec, tiles_c))
            x0 = jnp.clip((x - jnp.sqrt(1 - ab_t) * eps) / jnp.sqrt(ab_t),
                          -2.0, 2.0)
            x = jnp.sqrt(ab_n) * x0 + jnp.sqrt(1 - ab_n) * eps
            return (x, k), None

        pairs = jnp.stack(
            [t_steps, jnp.concatenate([t_steps[1:], jnp.array([-1])])], axis=1)
        (x, _), _ = jax.lax.scan(step, (x, kloop), pairs)
        return x[:h, :w]
