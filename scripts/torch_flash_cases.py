"""The flash-attention shapes of ``chip_smoke.py``: the prefill shapes
its phase (c) checks and times, the edges of the wgmma path it checks, the
softcap cases of its phase (c5), and the context-parallel splits of its
phase (s).
``scripts/torch_flash_times.py`` times the same lists. A case is (B, Sq,
Sk, Hq, Hkv, D, causal, window, dtype); a softcap case is (case,
q_offset, softcap); a split is (arch, Hq, Hkv, D, S, n ranks, window).
Imports torch only.
"""
import torch

# the serve paths' prefill shapes and a local-window case
MAIN_SHAPES = [(1, S, S, Hq, Hkv, 128, True, 0, dt)
               for Hq, Hkv in ((28, 4), (16, 16))      # qwen2-7b, olmoe-1b-7b
               for dt in (torch.bfloat16, torch.float32)
               for S in (32, 200, 1024)]
WINDOW_CASE = (1, 1024, 1024, 28, 4, 128, True, 64, torch.bfloat16)
# recurrentgemma-9b's local attention (Hq 16, Hkv 1, D 256, window 2048,
# which never binds at these lengths), then a window that binds at D 256
HYBRID_SHAPES = [(1, S, S, 16, 1, 256, True, 2048, dt)
                 for dt in (torch.bfloat16, torch.float32)
                 for S in (32, 200, 300, 1024)]
HYBRID_WINDOW_CASE = (1, 1024, 1024, 16, 1, 256, True, 256, torch.bfloat16)
# (m) / (n): the families with a stub tower. internvl2-1b's prompts are 256
# patch positions plus 32 / 200 / 768 / 300 text tokens, batched into 2048
# cache rows; whisper-base's are decoder prompts beside 1500 frames each,
# the self cache grown to whisper's own decoder context of 448
VLM_PROMPTS = (288, 456, 1024, 556)
AUDIO_PROMPTS = (4, 32, 200, 300)
AUDIO_FRAMES = 1500                     # whisper-base's n_encoder_frames
# every flash call of the (m) and (n) prefills: internvl2-1b's attention
# (Hq 14 over Hkv 2: group 7, D 64, causal) at each gang prompt;
# whisper-base's encoder self-attention (non-causal over the 1500 frames),
# and at each decoder prompt its causal self-attention and its non-causal
# cross-attention (Sq prompt tokens against the 1500 frames)
VLM_SHAPES = [(1, S, S, 14, 2, 64, True, 0, dt)
              for dt in (torch.bfloat16, torch.float32) for S in VLM_PROMPTS]
WHISPER_SHAPES = [(1, Sq, Sk, 8, 8, 64, causal, 0, dt)
                  for dt in (torch.bfloat16, torch.float32)
                  for Sq, Sk, causal in (
                      [(AUDIO_FRAMES, AUDIO_FRAMES, False)]
                      + [(S, S, True) for S in AUDIO_PROMPTS]
                      + [(S, AUDIO_FRAMES, False) for S in AUDIO_PROMPTS])]
# (d5) / (d6): granite-20b's multi-query attention (48 q heads on one kv
# head: a group of 48) and minitron-4b's GQA (24 over 8), D 128, causal
GRANITE_SHAPES = [(1, S, S, 48, 1, 128, True, 0, dt)
                  for dt in (torch.bfloat16, torch.float32)
                  for S in (32, 200, 1024)]
MINITRON_SHAPES = [(1, S, S, 24, 8, 128, True, 0, dt)
                   for dt in (torch.bfloat16, torch.float32)
                   for S in (32, 200, 1024)]
TIMED = MAIN_SHAPES + [WINDOW_CASE] + HYBRID_SHAPES + [HYBRID_WINDOW_CASE] \
    + VLM_SHAPES + WHISPER_SHAPES + GRANITE_SHAPES + MINITRON_SHAPES

# the edges of the bf16 wgmma path, (B, Sq, Sk, Hq, Hkv, D, causal,
# window), bf16 (tests/test_torch_flash_attention.py's WGMMA_EDGES): Sq and
# Sk not multiples of the 64- or 128-row tiles (77, 129, 300), Sq = 1, Sq
# != Sk non-causal (300 x 1500), GQA groups 1, 7, 8 and 48, every head
# dim, and window 40 at S 300: a block takes 64 q rows at D <= 128 and 128
# at D 256, and in the block at rows 128-191 the last warp's rows, at D
# 256 in the block at rows 128-255 the second warpgroup's, are all masked
# in the first kv tile visited.
WGMMA_EDGES = [(1, 77, 77, 4, 4, 64, True, 0),
               (2, 129, 129, 14, 2, 64, True, 0),
               (2, 300, 300, 28, 4, 64, True, 0),
               (1, 300, 300, 8, 8, 64, True, 40),
               (1, 300, 1500, 8, 8, 64, False, 0),
               (1, 1, 1, 4, 1, 64, True, 0),
               (1, 300, 300, 48, 1, 128, True, 0),
               (1, 300, 300, 56, 8, 128, True, 40),
               (1, 200, 200, 16, 1, 128, True, 16),
               (1, 300, 1500, 48, 1, 128, False, 0),
               (1, 1, 1, 48, 1, 128, True, 0),
               (1, 300, 300, 16, 1, 256, True, 40),
               (1, 129, 129, 7, 1, 256, True, 0),
               (1, 77, 300, 16, 1, 256, False, 0),
               (1, 1, 1, 16, 1, 256, True, 0)]

# the logit softcap, (case, q_offset, softcap): qwen2-7b at S 1024,
# recurrentgemma-9b's D 256 under its 2048 window, whisper-base's
# non-causal cross shape (300 x 1500), qwen2-7b's last context-parallel
# rank of 4 (256 query rows at key offset 768) and granite-20b's MQA; each
# at softcap 1.0, where N(0, 1) inputs give scaled scores past +-1 so the
# cap bends them, and at Gemma 2's 50.0
SOFTCAP_SHAPES = [((1, 1024, 1024, 28, 4, 128, True, 0), 0),
                  ((1, 1024, 1024, 16, 1, 256, True, 2048), 0),
                  ((1, 300, AUDIO_FRAMES, 8, 8, 64, False, 0), 0),
                  ((1, 256, 1024, 28, 4, 128, True, 0), 768),
                  ((1, 1024, 1024, 48, 1, 128, True, 0), 0)]
SOFTCAPS = (1.0, 50.0)
SOFTCAP_CASES = [((*shape, dt), q_offset, cap)
                 for shape, q_offset in SOFTCAP_SHAPES
                 for dt in (torch.bfloat16, torch.float32)
                 for cap in SOFTCAPS]

# (s): context-parallel attention per rank, (arch, Hq, Hkv, D, S, n ranks,
# window): qwen2-7b causal at S 1024 over 4 and 16 ranks, and
# recurrentgemma-9b at S 4096 over 16 ranks, where the 2048 window cuts
# the late ranks' kv walk
CP_CASES = [("qwen2-7b", 28, 4, 128, 1024, 4, 0),
            ("qwen2-7b", 28, 4, 128, 1024, 16, 0),
            ("recurrentgemma-9b", 16, 1, 256, 4096, 16, 2048)]
