"""Multi-ControlNet composition: sum residuals from several ControlNets.

Reference counterpart: ``FluxMultiControlNetModel``
(RepText/controlnet_flux.py:416-529) — runs each ControlNet on its own
conditioning (or one union-mode net over several conditionings) and sums the
per-block residual lists. Differences here:

- residual stacks from nets of different depths are spread onto the base
  model's injection slots (ceil-interval rule) BEFORE summing, so composition
  is well-defined for heterogeneous nets (the reference zips lists, silently
  truncating on mismatch);
- per-net optional token masks (regional gating) and conditioning scales;
- the whole composite is one pure function, jit/scan-safe, usable inside the
  fused samplers.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from reptext.models.controlnet import RepTextControlNet
from reptext.models.flux import _spread_residuals


@dataclasses.dataclass(frozen=True)
class ControlNetEntry:
    """One ControlNet + its static call configuration."""

    model: RepTextControlNet
    conditioning_scale: float = 1.0
    # union-mode nets take a mode index per call (reference :294-301)
    uses_mode: bool = False
    # per-net step-fraction window (diffusers control_guidance_start/end,
    # reference pipeline :760-761,999-1005: active iff i/T >= start and
    # (i+1)/T <= end). Applied when __call__ receives step_index/num_steps.
    guidance_start: float = 0.0
    guidance_end: float = 1.0


class MultiControlNet:
    """Compose N ControlNets; call returns summed, depth-aligned residuals."""

    def __init__(
        self,
        entries: Sequence[ControlNetEntry],
        base_num_layers: int,
        base_num_single_layers: int,
    ):
        if not entries:
            raise ValueError("MultiControlNet needs at least one entry")
        self.entries = tuple(entries)
        self.base_num_layers = base_num_layers
        self.base_num_single_layers = base_num_single_layers

    def __call__(
        self,
        params_list: Sequence[Any],            # one param tree per entry
        hidden_states: jax.Array,              # [B, S, C]
        conds: Sequence[jax.Array],            # per entry: [B, S, F_i]
        encoder_hidden_states: jax.Array,
        pooled_projections: jax.Array,
        timestep: jax.Array,
        img_ids: jax.Array,
        txt_ids: jax.Array,
        guidance: Optional[jax.Array] = None,
        token_masks: Optional[Sequence[Optional[jax.Array]]] = None,  # [S,1] each
        modes: Optional[Sequence[Optional[jax.Array]]] = None,
        step_index: Optional[jax.Array] = None,   # traced scan step i
        num_steps: Optional[int] = None,          # static schedule length T
    ) -> Tuple[jax.Array, jax.Array]:
        """When ``step_index``/``num_steps`` are given, each entry's residuals
        are gated by its (guidance_start, guidance_end) window — the
        per-controlnet keep list of the reference pipeline
        (RepText/pipeline_flux_controlnet.py:999-1005). The gate is a traced
        0/1 multiply so the composite stays one jit/scan-safe graph."""
        if len(params_list) != len(self.entries) or len(conds) != len(self.entries):
            raise ValueError("params/conds count must match entries")
        masks = token_masks or [None] * len(self.entries)
        modes = modes or [None] * len(self.entries)

        block_sum = None
        single_sum = None
        for entry, params, cond, mask, mode in zip(
            self.entries, params_list, conds, masks, modes
        ):
            kwargs = dict(conditioning_scale=entry.conditioning_scale)
            if entry.uses_mode:
                kwargs["mode"] = mode
            block, single = entry.model.apply(
                params, hidden_states, cond, encoder_hidden_states,
                pooled_projections, timestep, img_ids, txt_ids, guidance,
                **kwargs,
            )
            if mask is not None:
                block = block * mask.astype(block.dtype)
                single = single * mask.astype(single.dtype)
            if step_index is not None and num_steps is not None and (
                entry.guidance_start > 0.0 or entry.guidance_end < 1.0
            ):
                frac = step_index / num_steps
                keep = (
                    (frac >= entry.guidance_start)
                    & ((step_index + 1) / num_steps <= entry.guidance_end)
                )
                block = block * keep.astype(block.dtype)
                single = single * keep.astype(single.dtype)
            block = _spread_residuals(block, self.base_num_layers)
            single = _spread_residuals(single, self.base_num_single_layers)
            block_sum = block if block_sum is None else block_sum + block
            single_sum = single if single_sum is None else single_sum + single
        return block_sum, single_sum
