"""Model configuration schema: the JAX package's ``ModelConfig``, field for
field, covering all its architecture families."""

from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Family
    num_layers: int
    d_model: int
    vocab: int

    # -- attention ------------------------------------------------------
    n_heads: int = 0
    n_kv_heads: int = 0
    head_dim: int = 0
    attn_kind: Literal["gqa", "mla", "none"] = "gqa"
    rope_theta: float = 10_000.0
    rope_fraction: float = 1.0          # partial rotary (stablelm: 0.25)
    mrope: bool = False                  # Qwen2-VL multimodal RoPE
    mrope_sections: tuple[int, int, int] = (16, 24, 24)  # t/h/w of head_dim/2
    parallel_block: bool = False         # Cohere parallel attn+FFN
    attn_bias: bool = False
    qk_norm: bool = False

    # -- FFN --------------------------------------------------------------
    d_ff: int = 0
    ffn_act: Literal["swiglu", "gelu"] = "swiglu"

    # -- MLA (DeepSeek-V2 / MiniCPM3) --------------------------------------
    q_lora: int = 0                      # 0 = direct q projection
    kv_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # -- MoE ----------------------------------------------------------------
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    moe_d_ff: int = 0                    # per-expert hidden
    shared_d_ff: int = 0                 # shared-experts hidden (total)
    first_dense_layers: int = 0          # leading dense-FFN layers (DS-V2)
    router_scale: bool = False           # normalize top-k gates (DS-V2)

    # -- SSM (Mamba2/SSD) ----------------------------------------------------
    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_headdim: int = 64
    ssm_ngroups: int = 1
    # chunks of up to 2 * ssd_chunk - 1 rows (S / max(S // ssd_chunk, 1));
    # the card's ssd_chunk kernel takes up to ssd_chunk_max_q rows, 576 on
    # an H100, so up to ssd_chunk = 288 every sequence length runs there
    ssd_chunk: int = 128

    # -- hybrid (Zamba2) -------------------------------------------------------
    shared_attn_every: int = 0           # one shared attn block per N ssm layers
    shared_attn_lora: int = 0            # per-invocation LoRA rank on shared block

    # -- enc-dec (Seamless backbone) -------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0
    num_frames: int = 512                # stub frontend: frames per sample

    # -- vlm (Qwen2-VL backbone) -------------------------------------------------
    num_patches: int = 0                 # stub frontend: patch embeds per sample

    # -- common -----------------------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # -- training -----------------------------------------------------------------
    remat: str = "dots"                  # none | dots | full
    scan_layers: bool = True

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def group(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    def validate(self) -> "ModelConfig":
        if self.attn_kind == "gqa" and self.n_heads \
                and self.n_heads % max(self.n_kv_heads, 1):
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")
        if self.moe and not (self.top_k > 0 and self.n_experts > 0
                             and self.moe_d_ff > 0):
            raise ValueError(f"{self.name}: MoE needs top_k, n_experts and "
                             "moe_d_ff > 0")
        if self.family in ("ssm", "hybrid") and not (
                self.d_state > 0 and self.d_inner % self.ssm_headdim == 0):
            raise ValueError(f"{self.name}: SSM needs d_state > 0 and "
                             "d_inner divisible by ssm_headdim")
        return self



def param_count(cfg: ModelConfig) -> int:
    """Approximate parameter count (used for 6*N*D MODEL_FLOPS)."""
    from repro_torch.models.lm import count_params_analytic

    return count_params_analytic(cfg)


def active_param_count(cfg: ModelConfig) -> int:
    """Active (per-token) parameters — MoE uses top-k + shared experts only."""
    from repro_torch.models.lm import count_params_analytic

    return count_params_analytic(cfg, active_only=True)
