#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
GPU: the quickest proof that the port builds, serves (the ViT and every
LM family, and an LM prompt under the paper's TDM) and trains (the ViT and
every LM family) on the card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. Device: require CUDA; print the card's name and power limit
   (``nvidia-smi``).
2. Build: compile the hand-written kernels (``kernels/csrc/*.cu``, one
   ``nvcc`` each, concurrently) and print the build seconds; from the
   SASS, the fp32 non-causal attention kernels and their backward's issue
   no tensor-core instruction (no TF32; the backward no atomic either),
   the fp16 ones issue HMMA, and the
   bf16 backward's two kernels (dQ, dK/dV) in both its forms at each head
   width issue HGMMA (wgmma), no HMMA and no atomic, the non-causal bf16
   prefill's kernels HGMMA and no HMMA, the non-causal decode's HMMA.
3. Every kernel entry point against its plain PyTorch version on the
   card, at the main path's shapes (DeiT-Small: M=788 rows for the SBMMs
   over fp32, fp16 and int8 blocks with per-block and per-channel scales;
   B=4 x N=197 tokens x 6 heads for attention on fp32 and fp16 operands,
   each row also computed alone and padded past its kv_len (bitwise
   equal), plus rows without a key (kv_len <= 0: uniform over all N keys,
   as in the reference) and Dh 16 at N = 17 and 65;
   k=138 for the hard TDM (each row also computed alone, bitwise equal);
   the soft TDM's first application and a later one with package masses
   at per-row positions in a token-padded tile; both TDMs on random and
   on tie-heavy scores (three levels, padded rows 0), kept rows bitwise;
   causal GQA attention at full-width Minitron-4B through the kernel the
   wrapper picks: a per-slot prefill of a 512-token bucket, a batch-4
   decode and a decode row spanning all 9 key splits against a 572-slot
   bf16 cache, and the prefill and batch-4 decode at StableLM-1.6B's 32
   heads of Dh 64 and at Granite-MoE-3B-A800M's 24 over 8 heads of Dh 64,
   two launches bitwise equal); the same two entry points' non-causal
   kernels (``causal`` 0: bf16, any Nq and Nk, GQA;
   ``MM_NONCAUSAL_CASES``) at Whisper-base's encoder self-attention [4,
   1500, 8, 64], its cross-attention at prefill (q [4, 32, 8, 64]) and
   decode (q [4, 1, 8, 64]) over 1500 frames, Llama-3.2-Vision-90B's
   cross layers at prefill (q [2, 64, 64, 128]) and decode (q [2, 1, 64,
   128]) over [2, 1601, 8, 128], Dh 16 at 8 and 33 keys, and a case for
   each other branch of their design (whole keys at Dh 128 with one
   warpgroup, a decode split holding one key, two head tiles): o within
   one bf16 ulp of the plain version, two launches bitwise equal, each
   call one launch counted under its form;
   the SSM and hybrid families' scans
   (``mamba_scan_f32`` at Zamba2-1.2B's widths, ``wkv6_f32`` at
   RWKV6-1.6B's) at the recurrent serve's whole-batch prefill (B 4, S 512,
   also with strong decays down to exactly 0), its re-prefill length (S
   500) and decode (B 4, S 1): y within 1e-5 x max(1, max|plain|); the
   final state bitwise in the sequential form (decode), within 1e-5 x
   max(1, max|plain|) in the chunked form (prefill); two launches bitwise
   equal; the prefill split at 200 with the state carried, within the
   same bounds of one pass; the scans' backward (``mamba_scan_bwd_f32``,
   ``wkv6_bwd_f32``) at the training step's widths and 8 x 512 (bf16,
   zero states; the chunked form) and at the edges (``SCAN_BWD_CASES``:
   fp32, S 1, each side of the chunked form's first length, 33 and 70,
   strong decays, decays exactly 1, nonzero initial states and
   final-state gradients): every gradient within 1e-5 x max(1,
   max|plain|) of the plain backward, two launches bitwise equal, no
   atomic in either library's SASS (the chunked kernels' products on
   HMMA, the sequential walk on none); LM
   training's causal pair at
   full-width StableLM-1.6B ([8, 512, 32, 64]) and at GQA 3:1 ([2, 512,
   24 over 8, 64]): the forward writing the log-sum-exp (o bitwise the
   serve's, lse within 1e-5) and ``flash_prefill_bwd_bf16`` (dq, dk, dv
   within one bf16 ulp of the plain backward, two launches bitwise equal),
   also at Llama-3.2-Vision-90B's self-attention ([8, 512, 64 over 8,
   128]) and at Dh 128 with a ragged last tile ([2, 130, 16 over 2, 128]);
   the VLM and audio families' non-causal training pair
   (``MM_TRAIN_CASES``: Whisper-base's encoder [8, 1500, 8, 64], its
   cross-attention q [8, 64, 8, 64] over 1500 frames, Llama-3.2-Vision's
   cross layer q [8, 512, 64, 128] over [8, 1601, 8, 128], and at Dh 16
   Nq 5 < 64 < Nk 65 and 70 rows over 65 keys under GQA 8:1): the
   non-causal prefill writing the log-sum-exp (o bitwise the serve's, lse
   within 1e-5) and ``flash_prefill_bwd_bf16`` with ``causal`` 0, counted
   under ``flash_prefill_bwd_bf16/noncausal`` (dq, dk, dv within one bf16
   ulp of ``attention_noncausal_bwd_plain``, two launches bitwise equal),
   with fixed seeds: error and tolerance per output,
   kernel/plain/library times (CUDA events, median of 21 runs of 10 calls
   after warm-up) and each kernel's least possible time on an H100 SXM
   (published HBM rate, fp32 CUDA-core rate, and the fp16/bf16
   tensor-core rate for the products of two 16-bit values). Algorithm 1's
   pair at full-width DeiT-Small, batch 64, at each span's N (197, 140,
   100, 72; 6 heads, Dh 64), at N = 33 and at the reduced config ([8, 17,
   4, 16]):
   ``flash_attention_f32`` writing the log-sum-exp (o and probs bitwise
   the serve's, lse within 1e-5) and ``flash_attention_bwd_f32`` with and
   without the CLS probabilities' gradient (dq, dk, dv within 1e-5 x
   max(1, max|plain|), two launches bitwise equal); the TDM's pair at
   layers 2, 6 and 9 (z [64, 197 / 140 / 100, 384], k = 138 / 98 / 70)
   and the reduced config: ``token_drop_f32`` writing the kept indices
   (output bitwise the serve's, indices the plain version's) and
   ``token_drop_bwd_f32`` (dz bitwise at CLS and kept rows, dropped rows
   and dscores within 1e-6 x max(1, max|plain|), dscores 0 at CLS and
   kept rows, two launches bitwise equal). Each SBMM
   entry point also recomputes every row of its 788-row call alone (M = 1)
   and must match it bitwise, and prints the host's cost of issuing one
   ``sbmm()`` call and one library call; the host's cost of reading the
   current stream is printed once.
4. Main path, one serving path after another, each driven with the launch
   counts set to 0 just before a serve and read just after: full-width
   DeiT-Small (12 layers, D=384, 224 px; random weights from a seed)
   serving 16 requests of mixed resolution and keep rate through
   ``VisionEngine`` (4 slots, planner "full"):
   a. the fp32 tier with hard TDM, at pipeline depth 1 and then 2, each
      after one warm-up serve and timed over 5 serves;
   b. the fp16 tier, the int8 tier (per-channel scales) and the int8 tier
      with per-block scales, each with every other request soft-pruned,
      after one warm-up serve and timed over 3 serves.
   Every serve runs under ``torch.cuda.set_sync_debug_mode("warn")``,
   which counts the host's waits on the card other than the pipeline's
   per-step event; any such wait fails the run (once the profile below is
   printed). Checks: every request served with finite logits; every
   kernel entry point of the path launched during each serve, and every
   request dispatched at the path's tier; logits agree with the offline
   oracle ``forward_vit_packed`` (same soft flag and tier) per request
   within 1e-4 relative at fp32 and int8 and 5e-4 at fp16
   (``ORACLE_TOL``), top-1 equal; at fp16 it also prints how far the
   oracle alone moves for a one-ulp change of its fp32 input; at fp32 the
   two depths agree and the packed forward agrees with the plain
   masked-dense reference (no kernel: ``forward_vit`` on CPU copies) with
   token pruning off.
   c. The dense LM: full-width Minitron-4B (32 layers, D=3072, 24 query
      over 8 KV heads, vocab 256000; random weights from seed 0 drawn on
      the card, served from a bf16 copy) answering 8 requests (prompts of
      96, 200, 384 and 500 tokens, twice; 32 new tokens each) through
      ``ServeEngine`` with 4 slots and a 572-slot cache: continuous at
      pipeline depths 1 and 2, continuous with KV pruning (keep 0.5 every
      4 steps) and static waves, each after one warm-up and timed over 2
      serves. Checks: every request gets 32 tokens; the decode kernel
      launches once per layer of every decode call and the prefill kernel
      once per layer of every prefill call, both of which run; the pruned
      serve prunes; depths 1 and 2 give identical
      tokens; the teacher-forced oracle (``forward_lm`` over prompt plus
      generated tokens, no cache) puts each engine token's logit within
      0.05 of its position's largest (continuous depth 1 and static);
      no host wait besides the step events. Prints tokens/s, steps, ms
      per step and per decode step, and one decode step timed alone.
   d. The MoE LMs (``moe_path``, after the profile of c): full-width
      Granite-MoE-3B-A800M (32 layers, D=1536, 24 query over 8 KV heads of
      Dh 64, 40 experts top-8, d_ff 512, vocab 49155; weights from seed 0
      drawn on the card in fp32, the bf16 copy made and the fp32 draw
      dropped, the peak printed) through the same 8 requests, engine and
      serves as c, each timed over one serve (``MOE_REPEATS``). Checks as
      c, and: the call-for-call oracle (each
      request alone through its own prefill call at the engine's bucket,
      so capacity and drops are the engine's, then teacher-forced decode
      calls of all the requests together, B = 8 <= C = 8: no drop)
      within 0.05 on continuous depth 1 (static waves prefill slot by
      slot through the same calls: held by it when their tokens are the
      same, else checked alike); a no-drop variant (capacity factor E /
      K) served once continuous at depth 1 and in static waves under the
      teacher-forced oracle of c; no plain attention on the card. Prints
      the real (token, expert) pairs dropped per prefill call and its aux
      loss, one continuous serve at 8 of the 32 layers profiled on the
      card's side (busy, idle share, launches) and one decode step alone
      (wall, device launches, device time against the weights' bytes over
      the HBM rate and by part: causal kernels, expert GEMMs, the rest of
      the MoE FFN, the rest). Then Qwen2-MoE-A2.7B at full width and 4 of its 24 layers
      (its shared expert and Dh 128), continuous at depth 1, under the
      call-for-call oracle.
   e. The SSM and hybrid families (``ssm_path``, after d): full-width
      Zamba2-1.2B (38 Mamba2 layers of 64 heads of dh 64 and state 64, a
      shared attention block of 32 MHA heads of Dh 64 after every 6,
      vocab 32000) and RWKV6-1.6B (24 layers of 32 WKV heads of dh 64,
      d_ff 7168, vocab 65536), weights from seed 0 drawn on the card in
      fp32 and served from a bf16 copy, through the same 8 requests and
      engine as c (every admission a whole-batch re-prefill: recurrent
      state cannot be prefilled slot by slot): Zamba2 continuous at
      depths 1 and 2, with KV pruning and in static waves, RWKV6
      continuous at depths 1 and 2, each timed over one serve after a
      warm-up. Gates: (a) the scan kernel (``mamba_scan_f32``,
      ``wkv6_f32``) once per recurrent layer of every call, the causal
      pair once per shared block of every call, no plain scan or
      attention on the card; depths 1 and 2 identical; (b) the
      call-for-call oracle: per request, one ``forward_lm`` over its row
      as last prefilled (pad tokens and all) plus the tokens decoded
      after it, each such token within 0.05 of its position's largest or
      within the model's own bf16 noise where that is larger (the same
      forward with a random half of the embedding moved by one bf16 ulp,
      the witness): RWKV6 at full depth, Zamba2 cut to 7 layers (one
      stage, its shared block and a tail layer) and served once for it;
      at Zamba2's 38 layers the witness swamps any tolerance (the
      random-init model is chaotic in bf16, as the reference is), so
      there it is printed only; (c) at the first prune of
      the pruned Zamba2 serve, the shared blocks' caches compacted and
      every Mamba2 state passed on as it was. Prints tokens/s, the peak
      memory, one decode step alone (wall, device launches, idle share,
      device time against its bytes' floor and by part: scan, causal
      kernels, GEMMs, the rest) and one whole-batch re-prefill alone (B
      4, S 500: device time by the same parts).
   c2. The paper's TDM on LM prompts (``prefill_tdm_path``, after c's
      profile, on c's weights): ``models/prefill_prune
      .pruned_prefill_logits`` over 4 prompts of 500 tokens at r_t 0.7 at
      layers (2, 6, 9) against the dense prefill of the same prompts, in
      turns. Gates: 175 tokens left, finite logits, the prefill kernel
      once per layer and the decode kernel once per TDM layer (the score
      row), no other launch; at 12 of the 32 layers, one prompt, the
      kept positions equal to the CPU's (fp32) at each TDM layer or
      differing only at near-ties (within 5% of the CPU's k-th score,
      the card's kept sets then replayed on the CPU), and the card's
      argmax token's CPU logit within 0.05 of the CPU's largest. Prints
      the wall and device time against the dense prefill's.
   f. The VLM and audio families (``multimodal_path``, after e), each
      through ``models/steps.make_prefill`` and ``make_decode_step``
      (greedy, left-padded prompts with ``valid_start``, weights from
      seed 0 drawn on the card in fp32 and served from a bf16 copy):
      full-width Whisper-base (6 encoder and 6 decoder layers, D 512, 8
      heads of Dh 64, vocab 51,865, biases), 4 requests with their own
      1500 audio frames, prompts of 4, 9, 16 and 32 tokens, 64 generated
      each; Llama-3.2-Vision-90B at full width (D 8192, 64 query over 8
      KV heads of Dh 128, d_ff 28,672, vocab 128,256, 1601 vision tokens)
      and 2 of its 20 stages (4 self-attention layers and a gated cross
      layer each; 1 where the fp32 draw and its copy do not fit; the
      depth printed as "reduced"), every gate 1.0, 4 requests with their
      own vision embeddings, prompts of 16-64 tokens, 32 generated each.
      Per model one warm-up serve, one timed and one profiled. Gates:
      the timed serve launches exactly the causal kernels once per
      self-attention layer of every step and their non-causal kernels
      once per cross layer of every step (and per encoder layer at Whisper's
      prefill), nothing else; no plain attention on the card; every
      generated token within 0.05 of its position's largest logit in the
      teacher-forced oracle (``forward_lm`` in train mode over the
      request's prompt and tokens with its own modality input). Prints
      tokens/s, launches per serve, host syncs, the profiled serve's
      device busy and idle share and device time by kernel form.
5. Profile (``torch.profiler``): each kernel's device time per launch at
   the phase-3 shapes (the causal backward's also per kernel), the device
   time of all its wrapper call's device
   work, and its library call's device time per call (an ``sbmm()``,
   ``token_drop()`` or ``token_package()`` call that runs more than its
   one kernel on the card fails the run); for one depth-1 serve of each
   path, the device-busy
   and idle share, the device time by kernel and the engine's host spans
   (plan / stage / dispatch / complete), and the host's self time by
   operator and CUDA runtime call; the same for one continuous depth-1
   serve of the LM at 8 of its 32 layers, with the decode and prefill
   kernels' device time and launches, each and together, against its
   device busy time.
5b. Traffic (``traffic_path``): seeded traces replayed on the harness's
   virtual clock through ``launch/serve_trace.build_driver`` and
   ``traffic.TrafficHarness``, each replay with the launch counts set to
   0 just before it and read just after, under sync debug mode.
   Vision: full-width DeiT-Small with the main path's weights (4 slots,
   planner "full", fp32); a back-to-back probe replay gives the modeled
   capacity and mean service time, then a bursty trace of 32 requests
   (196 / 169 / 49 patches, keep rates default / 0.7 / 0.5, half
   soft-pruned, a deadline of 2 service times on half) at 4x capacity,
   replayed at depths 1 and 2 and with ``quality="auto"`` under an
   admission budget of 4 service times. LM: full-width StableLM-1.6B (24
   layers, D=2048, 32 heads, Dh 64, vocab 100352; weights from seed 0
   drawn on the card, served from a bf16 copy; 4 slots, a 572-slot
   cache) replaying 8 bursty requests (prompts of 96-500 tokens, 32 new
   tokens, a 400 ms deadline on half, 1 ms per token) at depths 1 and 2
   and under a 1000 ms budget. Gates: (a) every kernel of the path
   launched in each replay (the LM's once per layer of every call); (b)
   every admitted request completed; (c) lifecycles, reports and outputs
   digests identical at depths 1 and 2; (d) the vision logits against
   ``forward_vit_packed`` (``ORACLE_TOL``, top-1) and the LM tokens
   against the teacher-forced oracle; (e) the replay's outputs against a
   direct ``serve()`` of the same requests (vision within
   ``ORACLE_TOL``, top-1 equal; LM tokens identical); (f) the lifecycle
   and report equal to the same replay on the CPU (vision: the same
   weights; LM: reduced StableLM-1.6B, whose schedule counts tokens
   only); (g) each budget rejects a request, which then has no output
   and no slot; (h) no host wait besides the step events. Prints each
   replay's latency percentiles, time to first dispatch, goodput, miss
   rate, queue depth, rejections, trace fingerprint, wall and launches,
   and, from one profiled depth-1 LM replay, the causal kernels' device
   time per launch beside their Dh-64 serve cases of phase 3 (device
   time, SDPA's, bound).
6a. LM training (``lm_train_path``): ``models/steps.make_train_step`` on
   full-width StableLM-1.6B (24 layers, D=2048, 32 heads, Dh 64, vocab
   100352; 1.64 B params from seed 0 drawn on the card, scores from seed
   7) with ``launch/train``'s ``--prune`` config (block 16, r_b 0.5),
   batches of 8 x 512 tokens from ``synthetic_lm_batch``, AdamW at lr
   1e-3, bf16 activations, full remat, 8 steps and one profiled. Gates:
   (a) the loss falls; (b) step 0 at 2 layers, batch 2, seq 128 on the
   card (bf16, kernels) against the CPU (fp32, plain): loss within 1e-3
   relative, each gradient leaf within 5% of its largest element; (c)
   every step launches ``flash_prefill_bf16`` 48 times (forward and
   recompute) and ``flash_prefill_bwd_bf16`` 24 times, nothing else, and
   no plain attention runs; (d) TF32 off. AdamW updates in place. Prints
   the wall per step, tokens/s, peak memory, the profiled step's device
   busy and idle share and its device time by part (attention forward
   and backward, GEMMs, AdamW, the rest), the backward's device ms per
   step beside ``LM_TRAIN_BWD_REF_MS`` and the 8-step loss beside
   ``LM_TRAIN_LOSS_REF`` and the functional update's
   ``LM_TRAIN_LOSS_FUNCTIONAL``.
6b. MoE training (``moe_train_path``, after 6a's state is freed): the
   same ``make_train_step`` (AdamW in place, as 6a's) on full-width
   Granite-MoE-3B-A800M (32 layers, D=1536, 24 query over 8 KV heads of
   Dh 64, 40 experts top-8, d_ff 512, vocab 49155; 3.37 B params from
   seed 0 drawn on the card, scores from seed 7) with ``--prune`` (block
   16, r_b 0.5, the banks' columns and rows per expert), batches of 8 x
   512 tokens (capacity 1,024 pairs an expert), AdamW at lr 1e-3, bf16
   activations, full remat, 8 steps and one profiled. Gates: (a) the loss
   falls; (b) step 0 at 2 layers, batch 2 x 128, card against CPU, both
   bf16: loss within 1e-3 relative, every token routed otherwise within
   the near-tie rule (its differing experts within 2 d of its k-th
   largest CPU probability; the count printed per layer); with the
   card's routing replayed on the CPU, each gradient leaf within 5% of
   its largest (the free run's errors printed); (c) two
   step-0 gradient computations at 8 x 512 bitwise equal; (d) every step
   launches ``flash_prefill_bf16`` 64 times and ``flash_prefill_bwd_bf16``
   32, nothing else, and no plain attention runs; (e) TF32 off. Prints
   the wall per step, tokens/s, peak memory, the aux and the share of
   pairs dropped at step 0 and at the last step, the profiled step's
   busy and idle share, its device time by kernel group and by host
   range (expert GEMMs forward and backward, the rest of ``moe_ffn``,
   masks).
6c. Training the hybrid and SSM families (``ssm_train_path``, after
   6b): ``make_train_step`` with ``--prune`` (the hybrid's shared block,
   RWKV6's channel mix) on full-width Zamba2-1.2B (38 Mamba2 layers, no
   remat, as the reference) and RWKV6-1.6B (24 layers, full remat),
   batches of 8 x 512, AdamW at lr 1e-3, bf16 activations, 8 steps and
   one profiled each. Gates: (a) step 0 against the CPU at fp32
   (``SSM_TRAIN_STEP0``: Zamba2 at 1 layer of period 1, a Mamba2 layer
   and the shared block; RWKV6 at 2 layers): the loss within 1e-3 and
   every gradient leaf within 5% of its largest; (b) every loss
   finite; (c) every step launches exactly the scan pair once per
   recurrent layer (RWKV6's forward twice, recomputed) and the causal
   pair once per shared block, and no plain scan, scan backward or
   attention runs on the card. Prints the losses, wall per step, tokens/s,
   peak memory, the profiled step's busy and idle share, its device time
   by part and each scan kernel's device time per step.
6d. Training the VLM and audio families (``mm_train_path``, after 6c):
   ``make_train_step`` (no pruning: neither family's config has any) on
   full-width Whisper-base (6 encoder and 6 decoder layers, D 512, 8 heads
   of Dh 64, biases; batches of 8 rows of 64 tokens over 1500 frames) and
   Llama-3.2-Vision-90B at full width cut to 2 layers of cross_attn_period
   2 (one self-attention layer of 64 query over 8 KV heads of Dh 128 and
   one gated cross layer over 1601 vision tokens, 3.81 B params; printed
   as "reduced"; 8 x 512 tokens, or the first of 4 and 2 rows whose step
   fits), every cross gate ``MM_GATE``, AdamW at lr 1e-3, bf16
   activations, full remat (the VLM's by stage), 8 steps and one
   profiled each. Gates: (a) step 0 against the CPU at 2 layers (and 2
   encoder layers), batch 2, seq 128: the loss within 1e-3 and every
   gradient leaf within 5% of its largest, the cut's launches; (b) every
   loss finite; (c) every step launches exactly the causal pair once per
   self-attention layer and the non-causal pair once per cross layer
   (forwards twice, recomputed) and per encoder layer
   (``mm_train_launches``), and no plain attention runs on the card.
   Prints the losses, wall per step, tokens/s, peak memory, the profiled
   step's busy and idle share, its device time by part and per kernel
   form.
6. Training (``train_path``): the paper's Algorithm 1
   (``core/simultaneous``) on full-width DeiT-Small: a student (seed 0,
   its scores from the same generator) distilled from a dense DeiT-Small
   teacher (seed 1), batches of 64 from ``synthetic_vit_batch`` by step,
   AdamW (lr ``TRAIN_LR``, weight decay 0.01), ``total_steps`` 20, 11
   steps, fp32 with TF32 asserted off. The forward is ``forward_vit``
   differentiated by autograd, its attention and TDM on the kernels in
   both directions (``NonCausalAttention``, ``TokenDrop``), its matmuls
   cuBLAS. Gates: (a) the last loss below the first; (b) each step's
   r_b the cubic schedule's, non-increasing; (c) the scores moved; (d)
   step 0 on the card against the same step on the CPU (plain versions):
   the same tokens kept at every TDM first, by identity (the smallest
   score gap at the k-th kept token is printed, and the rows where
   near-tied kept tokens came out in another top-k order, with their
   smallest adjacent score gap), then the loss parts, then params and
   scores after the update (``TRAIN_*_TOL``; again at AdamW lr = eps =
   1, where the update is about the clipped gradient); (e) every step
   launches exactly ``flash_attention_f32`` 24 times (student 12 with
   lse, teacher 12), ``flash_attention_bwd_f32`` 12, ``token_drop_f32``
   3 and ``token_drop_bwd_f32`` 3, nothing else, and no plain version of
   attention or the TDM (forward or backward) runs on the card; (f) the
   trained scores' hard masks packed and the model served (16 requests,
   fp32, ``VisionEngine``): ``sbmm_f32``, ``flash_attention_f32`` and
   ``token_drop_f32`` launched, logits against the offline oracle within
   1e-4 and the packed forward against ``forward_vit`` on the masked
   params (no TDM, on CPU copies: the kernel-free oracle) within 1e-4.
   Prints the wall per step (median of 10 after step 0, the batch on the
   card beforehand), training images/s, peak device memory, one profiled
   step's device busy and idle share and the four kernels' device time
   in it, and the trained model's block density, head retained ratio and
   analytic compression ratio.
7. The script's total wall (``total: ... s``), a ``kernels`` JSON line
   (one entry per C entry point and one per form of ``backend.FORMS``,
   the entry points' non-causal kernels, whose launches the entry point's
   own line then leaves out; with the
   wrapper call's device time as ``call_device_ms`` and the library
   call's as ``library_device_ms``; ``launches``
   summed over the last timed serve of each path, the depth-1 replay of
   each trace, the trained model's serve and the last LM and ViT training
   steps among them, the LM's and the MoE LMs' continuous depth-1 serves,
   the multimodal serves and the LM replay for the causal kernels and
   their non-causal forms, whose entries list each of
   their
   shapes under ``cases`` and head with the first), then the last line
   ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 on CUDA cores,
# fp16 or bf16 operands with fp32 accumulation on tensor cores, HBM3
PEAK_FP32_FLOPS = 67e12
PEAK_FP16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def time_ms(fn, samples: int = 21, calls: int = 10, warmup: int = 5) -> float:
    """Per-call time of ``fn`` on the card's clock: CUDA events around
    ``calls`` back-to-back calls, divided by ``calls``; the median of
    ``samples`` such runs after ``warmup`` calls. A call whose host-side
    dispatch outlasts its device work is timed at its dispatch rate."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(samples):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(calls):
            fn()
        e.record()
        e.synchronize()
        ts.append(s.elapsed_time(e) / calls)
    return statistics.median(ts)


def bound_ms(n_bytes: float, n_ops: float, n_ops_f16: float = 0.0):
    """The least time of a call on the card: the larger of its bytes over
    the HBM rate and its operations over their peak rate. ``n_ops`` need
    fp32 (CUDA cores); ``n_ops_f16`` are products of two fp16 (or two
    bf16) values, exact in fp32, so they could run on the 16-bit tensor
    cores with fp32 accumulation, alongside the CUDA cores."""
    t_bytes = n_bytes / PEAK_HBM_BYTES * 1e3
    t_ops = max(n_ops / PEAK_FP32_FLOPS, n_ops_f16 / PEAK_FP16_FLOPS) * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------
SBMM_SHAPE = (788, 384, 384, 16)  # M, K, N, b


def host_ms(torch, fn, calls: int = 200) -> float:
    """Host time per call of ``fn``: the host's clock around ``calls``
    calls issued back to back without waiting on the card (the card keeps
    up, so this is what issuing one call costs the host)."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return dt


def check_sbmm(torch, dev):
    """The four SBMM entry points on one packed weight: fp32 blocks, fp16
    blocks, int8 blocks with per-block and per-channel scales; each
    against its plain version, and each row of the 788-row call recomputed
    alone (M = 1) bitwise equal to it."""
    import numpy as np
    from repro_torch.core import block_pruning as BP
    from repro_torch.core import quant as Q
    from repro_torch.core.packing import pack_weight
    from repro_torch.kernels import backend
    from repro_torch.kernels.sbmm import (pad_input, sbmm, sbmm_plain,
                                          sbmm_quant_plain)
    M, K, N, b = SBMM_SHAPE
    g = torch.Generator().manual_seed(1)
    w = torch.randn((K, N), generator=g) * 0.05
    mask = BP.hard_block_mask(torch.randn(BP.score_shape((K, N), b),
                                          generator=g), 0.5, (K, N), b)
    pw = pack_weight(w.numpy(), mask.numpy().astype(bool), b, device=dev)
    require(not np.array_equal(pw.col_perm, np.arange(pw.n_cols)),
            "sbmm check needs a non-identity col_perm")
    x = torch.randn((M, K), generator=g).to(dev)
    kept = int((pw.header >= 0).sum())
    stream_us = (host_ms(torch, lambda: torch.cuda.current_stream(
        dev).cuda_stream, 2000) * 1e3, host_ms(
        torch, lambda: backend.current_stream(dev), 2000) * 1e3)
    print(f"host: reading the current stream {stream_us[0]:.3f} us per call "
          f"through torch.cuda.current_stream(dev).cuda_stream, "
          f"{stream_us[1]:.3f} us through backend.current_stream", flush=True)
    variants = (("sbmm_f32", pw, "sbmm.cu"),
                ("sbmm_f16w", Q.quantize_packed(pw, "fp16"), "sbmm.cu"),
                ("sbmm_i8_block", Q.quantize_packed(pw, "int8", "block"),
                 "sbmm_quant.cu"),
                ("sbmm_i8_channel", Q.quantize_packed(pw, "int8", "channel"),
                 "sbmm_quant.cu"))
    checks = []
    for name, q, src in variants:
        quant = isinstance(q, Q.QuantizedPackedWeight)

        def plain(q=q, quant=quant):
            xp = pad_input(x, q)
            return (sbmm_quant_plain(xp, q.blocks, q.header, q.scales,
                                     q.col_map, N) if quant
                    else sbmm_plain(xp, q.blocks, q.header, q.col_map, N))

        y, ref = sbmm(x, q), plain()
        torch.cuda.synchronize()
        require(y.shape == (M, N) and y.is_contiguous(),
                f"{name}: output {tuple(y.shape)}, not [{M}, {N}] contiguous")
        err = (y - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item()
        split = [r for r in range(M) if not torch.equal(sbmm(x[r:r + 1], q)[0],
                                                         y[r])]
        require(not split, f"{name}: {len(split)} of {M} rows computed alone "
                           f"(M = 1) differ bitwise from the {M}-row call, "
                           f"first {split[:1]}")
        w_dense = q.to_dense().float()  # dequantized: the library's input

        def library(w_dense=w_dense):
            return x @ w_dense

        n_bytes = (4 * (x.numel() + pw.header.numel() + M * N)
                   + q.blocks.numel() * q.blocks.element_size()
                   + (q.scales.numel() * 4 if quant else 0)
                   + 8 * pw.n_cols)
        n_ops = 2 * M * b * b * kept + (b * b * kept if quant else 0)
        bnd, by = bound_ms(n_bytes, n_ops)
        checks.append(dict(
            name=name, source=src,
            errs=[("y", err, tol, "1e-4 x max|plain|")],
            fn=lambda q=q: sbmm(x, q),
            ms=time_ms(lambda q=q: sbmm(x, q)), plain_ms=time_ms(plain),
            library_fn=library, library_ms=time_ms(library),
            library_call="x @ W_dense (cuBLAS fp32 on the dequantized "
                         "weight)",
            host=(host_ms(torch, lambda q=q: sbmm(x, q)),
                  host_ms(torch, library)),
            bound_ms=bnd, bound_by=by,
            shapes=f"x[{M},{K}] blocks{list(q.blocks.shape)} "
                   f"{str(q.blocks.dtype)[6:]} kept={kept}; rows at M=1 "
                   f"bitwise those at M={M}"))
    return checks


# the non-causal kernels' edge cases (B, N, H, Dh, kv_len): rows without a
# key (kv_len <= 0: all N keys alike, as the reference's NEG_INF mask
# gives) beside a one-key row and a kv_len past N at the main path's
# shape, and the reduced DeiT's Dh 16 at N = 17 and 65
FLASH_EDGE_CASES = (
    (4, 197, 6, 64, (0, -2, 1, 202)),
    (4, 17, 6, 16, (17, 9, 1, 0)),
    (4, 65, 6, 16, (65, 40, 17, 0)),
)
FLASH_PAD = 13  # tokens of padding past kv_len[b] in the row-bits check


def check_flash_attention(torch, dev, half: bool):
    """One non-causal entry point (fp32 or fp16 operands) at the main
    path's shape against the plain version: o within 1e-4 (fp32) or 2e-3
    (fp16) of the largest plain element, the head-mean scores within 1e-4
    of theirs, exactly 0 at masked keys, all finite; the same gates on
    ``FLASH_EDGE_CASES``; and each row of the main call bitwise equal to
    the row computed alone (B = 1) and with ``FLASH_PAD`` tokens of
    padding past its ``kv_len``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import (attention_plain,
                                                     flash_attention)
    B, N, H, Dh = 4, 197, 6, 64
    lens = (197, 170, 140, 50)
    g = torch.Generator().manual_seed(2)
    dt = torch.float16 if half else torch.float32
    name = "flash_attention_f16" if half else "flash_attention_f32"
    q, k, v = (torch.randn((B, N, H, Dh), generator=g).to(dev, dt)
               for _ in range(3))
    kv_len = torch.tensor(lens, dtype=torch.int32, device=dev)
    # fp16 output: both sides round fp32 sums taken in another order to
    # fp16, so an element may differ by one fp16 ulp (2e-3 as the CPU
    # parity test of the fp16 tier)
    rule_o = "2e-3" if half else "1e-4"

    def gate(label, q, k, v, kv_len):
        """(o, scores) of the kernel and its errors against the plain
        version's, with their tolerances."""
        o, sc = flash_attention(q, k, v, kv_len, collect_scores=True)
        o_ref, p_ref = attention_plain(q, k, v, kv_len)
        sc_ref = p_ref.mean(dim=1)
        torch.cuda.synchronize()
        require(o.dtype == dt and sc.dtype == torch.float32,
                f"{name} ({label}): output {o.dtype}, scores {sc.dtype}")
        require(bool(torch.isfinite(o.float()).all())
                and bool(torch.isfinite(sc).all()),
                f"{name} ({label}): an output or score is not finite")
        for bi, L in enumerate(kv_len.tolist()):
            require(L <= 0 or bool((sc[bi, L:] == 0).all()),
                    f"{name} ({label}): nonzero score at a masked key "
                    f"(row {bi})")
        at = "" if label == "main" else f" ({label})"
        return o, sc, [
            ("o" + at, (o.float() - o_ref.float()).abs().max().item(),
             float(rule_o) * o_ref.float().abs().max().item(),
             f"{rule_o} x max|plain|"),
            ("scores" + at, (sc - sc_ref).abs().max().item(),
             1e-4 * sc_ref.abs().max().item(), "1e-4 x max|plain|")]

    o, sc, errs = gate("main", q, k, v, kv_len)
    for bi in range(B):
        rows = [t[bi:bi + 1] for t in (q, k, v)]
        one = flash_attention(*rows, kv_len[bi:bi + 1], collect_scores=True)
        pad = [torch.cat([t, torch.randn((1, FLASH_PAD, H, Dh), generator=g)
                          .to(dev, dt)], dim=1) for t in rows]
        padded = flash_attention(*pad, kv_len[bi:bi + 1],
                                 collect_scores=True)
        require(torch.equal(one[0][0], o[bi]) and
                torch.equal(one[1][0], sc[bi]),
                f"{name}: row {bi} computed alone (B = 1) differs bitwise "
                f"from the B = {B} call")
        require(torch.equal(padded[0][0, :N], o[bi]) and
                torch.equal(padded[1][0, :N], sc[bi]) and
                bool((padded[1][0, N:] == 0).all()),
                f"{name}: row {bi} with {FLASH_PAD} tokens of padding past "
                f"kv_len differs bitwise")
    for eb, en, eh, ed, elens in FLASH_EDGE_CASES:
        eq, ek, ev = (torch.randn((eb, en, eh, ed), generator=g).to(dev, dt)
                      for _ in range(3))
        errs += gate(f"N={en} Dh={ed} kv_len={list(elens)}", eq, ek, ev,
                     torch.tensor(elens, dtype=torch.int32, device=dev))[2]

    def plain():
        o, probs = attention_plain(q, k, v, kv_len)
        return o, probs.mean(dim=1)

    qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    amask = (torch.arange(N, device=dev)[None, :]
             < kv_len[:, None])[:, None, None, :]
    sum_len = sum(lens)
    # Q K^T and P V take 2 N sum_len H Dh operations each. With fp16
    # operands both run on the fp16 tensor cores: Q K^T multiplies two fp16
    # values (exact in fp32), P V two fp16 halves of the fp32 P by V, so it
    # is counted twice; with fp32 operands both run on the CUDA cores.
    n_qk = n_pv = 2 * N * sum_len * H * Dh
    n_rest = 2 * sum_len * H * Dh
    elt = 2 if half else 4
    n_bytes = (elt * (2 * B * N * H * Dh + 2 * sum_len * H * Dh)
               + 4 * (B + B * N))
    bnd, by = (bound_ms(n_bytes, n_rest, n_qk + 2 * n_pv) if half
               else bound_ms(n_bytes, n_qk + n_pv + n_rest))

    def library():
        return F.scaled_dot_product_attention(qh, kh, vh, attn_mask=amask)

    return dict(
        name=name, source="flash_attention.cu", errs=errs,
        fn=lambda: flash_attention(q, k, v, kv_len, collect_scores=True),
        ms=time_ms(lambda: flash_attention(q, k, v, kv_len,
                                           collect_scores=True)),
        plain_ms=time_ms(plain),
        library_fn=library, library_ms=time_ms(library),
        library_call=(f"F.scaled_dot_product_attention on {str(dt)[6:]} "
                      f"(bool key mask)"),
        bound_ms=bnd, bound_by=by,
        shapes=f"q,k,v[{B},{N},{H},{Dh}] {str(dt)[6:]} kv_len={list(lens)}; "
               f"rows bitwise alone and padded by {FLASH_PAD}")


TENSOR_CORE_OPS = ("HMMA", "HGMMA", "IMMA", "DMMA")
# global, shared and generic atomics and reductions
ATOMIC_OPS = ("ATOM", "ATOMS", "ATOMG", "RED", "REDG", "REDAS")


def _sass_ops(backend, lib, ops=TENSOR_CORE_OPS):
    """Counts of the instructions ``ops`` (by opcode, modifiers dropped) per
    kernel of library ``lib``, from its SASS."""
    counts, fn = {}, None
    for line in backend.disassemble(lib).splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = {}
        elif fn is not None and "*/" in line:
            words = line.split("*/", 1)[1].split()
            while words and (words[0] == "{" or words[0].startswith("@")):
                words = words[1:]  # a dual-issue brace, a predicate
            op = words[0].split(".")[0] if words else ""
            if op in ops:
                counts[fn][op] = counts[fn].get(op, 0) + 1
    return counts


def check_tensor_cores(backend):
    """Which kernels issue tensor-core instructions, from their SASS: the
    non-causal fp32 tier's none (no TF32 or other split product), nor its
    backward's two kernels, which issue no atomic either (their sums run
    in a fixed order); its fp16 tier's HMMA; the bf16 backward's two kernels
    (dQ, dK/dV) in both forms (causal, non-causal) at each head width HGMMA
    (wgmma), no HMMA and no atomic; the
    non-causal bf16 prefill's kernels (Dh 16, 64, 128; one and two
    warpgroups) HGMMA and no HMMA, the non-causal decode's HMMA; the scans'
    chunked kernels HMMA (their 3xTF32 products) and no atomic, their
    sequential kernels neither. Prints the count per kernel."""
    from repro_torch.kernels.flash_attention.ops import CAUSAL_HEAD_DIMS
    bwd_dims = CAUSAL_HEAD_DIMS["flash_prefill_bwd_bf16"]
    tiers = {}
    for fn, ops in _sass_ops(backend, "flash_attention").items():
        for tier in ("f32", "f16"):
            if f"flash_attention_{tier}_kernel" in fn:
                dh = fn.split("_kernelILi")[1].split("E")[0]
                tiers[f"flash_attention_{tier}_kernel<{dh}>"] = ops
    bwd = {}
    for fn, ops in _sass_ops(backend, "flash_prefill_bwd",
                             TENSOR_CORE_OPS + ATOMIC_OPS).items():
        for form in ("", "noncausal_"):
            for part in ("dq", "dkdv"):
                if f"flash_prefill_bwd_bf16_{form}{part}_kernel" in fn:
                    dh = fn.split("_kernelILi")[1].split("E")[0]
                    bwd[f"flash_prefill_bwd_bf16_{form}{part}_kernel<{dh}>"] \
                        = ops
    print("sass: tensor-core instructions per kernel "
          + json.dumps({**tiers, **bwd}), flush=True)
    require(len(tiers) == 4, f"expected 4 non-causal kernels in the SASS, "
                             f"found {sorted(tiers)}")
    for kern, ops in tiers.items():
        if "_f32_" in kern:
            require(not ops, f"{kern} issues tensor-core instructions {ops}")
        else:
            require(ops.get("HMMA", 0) > 0, f"{kern} issues no HMMA")
    vit_bwd = {}
    for fn, ops in _sass_ops(backend, "flash_attention_bwd",
                             TENSOR_CORE_OPS + ATOMIC_OPS).items():
        if "flash_attention_bwd_f32_kernel" in fn:
            dh = fn.split("_kernelILi")[1].split("E")[0]
            vit_bwd[f"flash_attention_bwd_f32_kernel<{dh}>"] = ops
        elif "flash_attention_bwd_f32_dq_sum_kernel" in fn:
            vit_bwd["flash_attention_bwd_f32_dq_sum_kernel"] = ops
    print("sass: tensor-core and atomic instructions of the fp32 attention "
          "backward " + json.dumps(vit_bwd), flush=True)
    require(sorted(vit_bwd) == ["flash_attention_bwd_f32_dq_sum_kernel",
                                "flash_attention_bwd_f32_kernel<16>",
                                "flash_attention_bwd_f32_kernel<64>"],
            f"expected the fp32 backward's main kernel at Dh 16 and 64 and "
            f"its dQ sum in the SASS, found {sorted(vit_bwd)}")
    for kern, ops in vit_bwd.items():
        require(not ops, f"{kern} issues tensor-core or atomic instructions "
                         f"{ops}")
    require(len(bwd) == 4 * len(bwd_dims),
            f"expected the backward's dq and dkdv kernels of both forms at "
            f"Dh {bwd_dims} in the SASS, found {sorted(bwd)}")
    for kern, ops in bwd.items():
        require(set(ops) == {"HGMMA"},
                f"{kern} must issue HGMMA and nothing else of "
                f"{TENSOR_CORE_OPS + ATOMIC_OPS} (no atomic), issues {ops}")
    nc = {}
    for lib, entry in (("flash_prefill", "flash_prefill_bf16"),
                       ("flash_decode", "flash_decode_bf16")):
        for fn, ops in _sass_ops(backend, lib).items():
            if f"{entry}_noncausal_kernelILi" in fn:
                args = fn.split("_kernelILi")[1].split("EE")[0]
                nc[f"{entry}_noncausal_kernel<"
                   f"{args.replace('ELi', ', ')}>"] = ops
    print("sass: tensor-core instructions of the non-causal kernels "
          + json.dumps(nc), flush=True)
    prefill = [k for k in nc if "prefill" in k]
    decode = [k for k in nc if "decode" in k]
    require(len(prefill) == 6 and len(decode) == 3,
            f"expected the non-causal prefill at Dh 16, 64 and 128 with one "
            f"and two warpgroups and the decode at each Dh in the SASS, "
            f"found {sorted(nc)}")
    for kern in prefill:  # wgmma, whose products are HGMMA
        require(nc[kern].get("HGMMA", 0) > 0 and not nc[kern].get("HMMA"),
                f"{kern} must issue HGMMA and no HMMA, issues {nc[kern]}")
    for kern in decode:  # mma.sync
        require(nc[kern].get("HMMA", 0) > 0,
                f"{kern} issues no HMMA: {nc[kern]}")
    scans = {}
    for lib, entry in (("mamba_scan", "mamba_scan_f32"), ("wkv6", "wkv6_f32")):
        for fn, ops in _sass_ops(backend, lib,
                                 TENSOR_CORE_OPS + ATOMIC_OPS).items():
            for form in ("chunked_kernel", "kernel"):
                if f"{entry}_{form}I" in fn:
                    t = "bf16" if "bfloat16" in fn else "f32"
                    scans[f"{entry}_{form}<{t}>"] = ops
    print("sass: tensor-core and atomic instructions of the scans "
          + json.dumps(scans), flush=True)
    require(len(scans) == 8, f"expected both forms of both scans at both "
                             f"input types in the SASS, found {sorted(scans)}")
    for kern, ops in scans.items():
        if "_chunked_" in kern:  # 3xTF32 products, no atomic
            require(set(ops) == {"HMMA"},
                    f"{kern} must issue HMMA and nothing else of "
                    f"{TENSOR_CORE_OPS + ATOMIC_OPS}, issues {ops}")
        else:
            require(not ops, f"{kern} issues tensor-core or atomic "
                             f"instructions {ops}")
    scan_bwd = {}
    for lib, entry in (("mamba_scan_bwd", "mamba_scan_bwd_f32"),
                       ("wkv6_bwd", "wkv6_bwd_f32")):
        for fn, ops in _sass_ops(backend, lib,
                                 TENSOR_CORE_OPS + ATOMIC_OPS).items():
            t = "<bf16>" if "bfloat16" in fn else "<f32>" if "IfE" in fn \
                else ""
            for part in ("chunk_kernel", "bounds_kernel", "kernel"):
                if f"{entry}_{part}" in fn:
                    scan_bwd[f"{entry}_{part}{t}"] = ops
                    break
            else:
                if f"{entry}_" in fn and "_sum_kernel" in fn:
                    scan_bwd[f"{entry} sum kernel"] = ops
    print("sass: tensor-core and atomic instructions of the scans' "
          "backward " + json.dumps(scan_bwd), flush=True)
    require(len(scan_bwd) == 14,
            f"expected each backward's sequential walk, boundary walk and "
            f"chunk kernel at both input types and its sum in the SASS, "
            f"found {sorted(scan_bwd)}")
    for kern, ops in scan_bwd.items():
        if "_chunk_kernel" in kern or "_bounds_kernel" in kern:
            require(set(ops) == {"HMMA"},
                    f"{kern} must issue HMMA and nothing else of "
                    f"{TENSOR_CORE_OPS + ATOMIC_OPS}, issues {ops}")
        else:
            require(not ops, f"{kern} issues tensor-core or atomic "
                             f"instructions {ops}")


# the causal kernels' cases at full-width Minitron-4B (24 query heads over 8
# KV heads, Dh 128, a 572-slot cache): a per-slot prefill of a 512-token
# bucket holding a prompt of 500 or 384 tokens (``flash_prefill_bf16``), a
# batch-4 decode and a decode row whose window spans all 9 of the cache's
# 64-key splits (``flash_decode_bf16``); then the prompt TDM's score row
# (``models/attention._score_row`` at ``PREFILL_TDM_LAYERS``: 4 prompts
# past the first TDM layer's 500, 352 and 248 tokens, the last query row
# over every key); the first case of each kernel is its headline
LM_CAUSAL_CASES = (
    ("prefill kv_start=12", 1, 512, [0], [512], [12]),
    ("prefill kv_start=128", 1, 512, [0], [512], [128]),
    ("decode", 4, 1, [129, 289, 419, 570], [130, 290, 420, 571],
     [32, 56, 0, 12]),
    ("decode 9 splits", 1, 1, [571], [572], [0]),
    *((f"TDM score row, {n} keys", 4, 1, [n - 1] * 4, [n] * 4, [0] * 4)
      for n in (500, 352, 248)),
)
LM_DECODE = LM_CAUSAL_CASES[2]  # the serve's decode shape
# the causal kernels at StableLM-1.6B's heads (32 MHA heads, Dh 64), the
# serves' shapes: a per-slot prefill of a 512-token bucket holding a
# 500-token prompt, and the batch-4 decode windows
LM_PREFILL_DH64 = ("prefill Dh 64", 1, 512, [0], [512], [12])
LM_DECODE_DH64 = ("decode Dh 64", 4, 1, [129, 289, 419, 570],
                  [130, 290, 420, 571], [32, 56, 0, 12])
LM_DH64 = (LM_PREFILL_DH64, LM_DECODE_DH64)
# the same two at Granite-MoE-3B-A800M's heads (24 query over 8 KV heads,
# GQA 3:1, head dim 64), the MoE serves' shapes
LM_GQA3 = (("prefill GQA 3:1, head dim 64", 1, 512, [0], [512], [12]),
           ("decode GQA 3:1, head dim 64", 4, 1, [129, 289, 419, 570],
            [130, 290, 420, 571], [32, 56, 0, 12]))
BF16_ULP = 2.0 ** -7  # one bf16 ulp, relative to the largest element


def check_flash_attention_causal(torch, dev):
    """The two causal kernels, each through the wrapper at the LM path's
    shapes (``LM_CAUSAL_CASES``, and the prefill and decode at
    StableLM-1.6B's 32 heads of Dh 64, ``LM_DH64``, and at
    Granite-MoE-3B-A800M's 24 over 8 heads of Dh 64, ``LM_GQA3``; the
    wrapper picks
    ``flash_decode_bf16``
    for one query row, ``flash_prefill_bf16`` for more) against the plain
    version: the output within one bf16 ulp of the largest plain element
    at rows with a valid key (both round fp32 sums taken in another order
    to bf16; left-pad rows have no key, where the kernel writes 0 and the
    plain version averages V: checked 0), the decode row's head-mean
    probabilities within 1e-6 and exactly 0 at masked keys, and two calls
    bitwise equal. Returns one entry per kernel, each case's numbers under
    ``cases``, the first case's as the entry's."""
    import torch.nn.functional as F
    from repro_torch.configs import MINITRON_4B
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import (attention_causal_plain,
                                                     flash_attention)
    from repro_torch.configs import GRANITE_MOE_3B_A800M, STABLELM_1_6B
    heads = {}
    for model, group in ((MINITRON_4B, LM_CAUSAL_CASES),
                         (STABLELM_1_6B, LM_DH64),
                         (GRANITE_MOE_3B_A800M, LM_GQA3)):
        for case in group:
            heads[case[0]] = (model.num_heads, model.num_kv_heads,
                              model.head_dim)
    S = 572
    g = torch.Generator().manual_seed(8)
    cases = {"flash_prefill_bf16": [], "flash_decode_bf16": []}
    for label, B, Nq, off, lens, starts in (*LM_CAUSAL_CASES, *LM_DH64,
                                            *LM_GQA3):
        Hq, KV, Dh = heads[label]
        q = torch.randn((B, Nq, Hq, Dh), generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn((B, S, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        off_t, len_t, st_t = (torch.tensor(x, dtype=torch.int32, device=dev)
                              for x in (off, lens, starts))
        decode = Nq == 1
        name = "flash_decode_bf16" if decode else "flash_prefill_bf16"

        def kern(q=q, k=k, v=v, b=(off_t, len_t, st_t), decode=decode):
            return flash_attention(q, k, v, causal=True, q_offset=b[0],
                                   kv_len=b[1], kv_start=b[2],
                                   collect_scores=decode)

        def plain(q=q, k=k, v=v, b=(off_t, len_t, st_t), decode=decode):
            o, p = attention_causal_plain(q, k, v, *b, collect_probs=decode)
            return (o, p.mean(dim=1)) if decode else o

        before = backend.launches()[name]
        res, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        require(backend.launches()[name] == before + 2,
                f"causal attention ({label}) did not launch {name}")
        o, o_ref = (res[0], ref[0]) if decode else (res, ref)
        require(all(torch.equal(x, y) for x, y in zip(
            res if decode else (res,), again if decode else (again,))),
            f"{name} ({label}): two launches on the same inputs differ")
        require(o.dtype == torch.bfloat16
                and bool(torch.isfinite(o.float()).all()),
                f"{name} ({label}): output {o.dtype} or not finite")
        # keys row i of batch row b sees: [start, min(len, off + i + 1))
        seen = [[max(0, min(lens[b], off[b] + i + 1) - starts[b])
                 for i in range(Nq)] for b in range(B)]
        real = torch.tensor(seen, device=dev) > 0
        require(bool((o[~real] == 0).all()),
                f"{name} ({label}): a row without a key is not 0")
        d = (o.float() - o_ref.float()).abs().amax(dim=(2, 3))
        err_o = d[real].max().item()
        tol_o = BF16_ULP * o_ref.float()[real].abs().max().item()
        errs = [(f"o ({label})", err_o, tol_o,
                 "one bf16 ulp at max|plain|")]
        if decode:
            errs.append((f"probs ({label})",
                         (res[1] - ref[1]).abs().max().item(), 1e-6, ""))
            keys = torch.arange(S, device=dev)
            masked = (keys < st_t[:, None]) | (keys >= len_t[:, None])
            require(bool((res[1][masked] == 0).all()),
                    f"{name}: nonzero probability at a masked key")
        # the work these inputs need: every (row, head, valid key) pair
        # takes 2 Dh operations for Q.K (bf16 x bf16, exact in fp32: the
        # bf16 tensor-core rate), 2 Dh for P.V and ~4 for the softmax. The
        # prefill's P.V counts at the bf16 rate, as the function needs it
        # (its kernel's split of P into hi and lo halves is its own extra
        # work, not counted); the decode kernel keeps P fp32: 2 Dh at the
        # fp32 rate. Bytes: q and o once, the K/V window [start, len) once,
        # the decode probabilities once.
        pairs = Hq * sum(map(sum, seen))
        window = sum(lens[b] - starts[b] for b in range(B))
        n_bytes = (2 * 2 * q.numel() + 2 * 2 * window * KV * Dh + 12 * B
                   + (4 * B * Hq * S if decode else 0))
        bnd, by = (bound_ms(n_bytes, (2 * Dh + 4) * pairs, 2 * Dh * pairs)
                   if decode else
                   bound_ms(n_bytes, 4 * pairs, 4 * Dh * pairs))
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
        pos = off_t[:, None] + torch.arange(Nq, device=dev)
        keys = torch.arange(S, device=dev)
        amask = ((keys >= st_t[:, None, None]) & (keys < len_t[:, None, None])
                 & (keys <= pos[:, :, None]))[:, None]

        def library(qh=qh, kh=kh, vh=vh, amask=amask):
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  attn_mask=amask,
                                                  enable_gqa=True)

        cases[name].append(dict(
            label=label, errs=errs, fn=kern, ms=time_ms(kern),
            plain_ms=time_ms(plain), library_fn=library,
            library_ms=time_ms(library),
            bound_ms=bnd, bound_by=by,
            shapes=f"q[{B},{Nq},{Hq},{Dh}] k,v[{B},{S},{KV},{Dh}] bf16 "
                   f"q_offset={off if B > 1 else off[0]} kv_len={lens} "
                   f"kv_start={starts}"))
    checks = []
    for name, cs in cases.items():
        head = cs[0]
        checks.append(dict(
            name=name, source=f"{name[:-5]}.cu",
            errs=[e for c in cs for e in c["errs"]], fn=head["fn"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            library_fn=head["library_fn"], library_ms=head["library_ms"],
            library_call="F.scaled_dot_product_attention(enable_gqa=True) "
                         "on bf16 (bool causal window mask)",
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cs),
            cases=cs))
    return checks


# the non-causal bf16 kernels (any Nq and Nk, GQA) at the multimodal
# serves' shapes (label, q shape, k/v shape): Whisper-base's encoder
# self-attention over 1500 audio frames (whole keys, two warpgroups a
# block), its cross-attention at prefill (a 32-token bucket: split keys)
# and decode (one head a group); Llama-3.2-Vision-90B's gated cross layers
# at prefill (64 tokens: split keys, two warpgroups) and decode (GQA 8:1 on
# the tensor cores) over 1601 vision tokens, Dh 128; Dh 16 at 8 and 33
# keys (the reduced configs); then the rest of the design's branches on a
# 132-SM card: whole keys with one warpgroup at Dh 128 (50 keys), a decode
# whose last split holds one key (65 keys, GQA 8:1: three warps see none
# of it) and one of 32 heads a group (two head tiles). The first case of
# each kernel is its headline.
MM_NONCAUSAL_CASES = (
    ("whisper encoder", (4, 1500, 8, 64), (4, 1500, 8, 64)),
    ("whisper cross prefill", (4, 32, 8, 64), (4, 1500, 8, 64)),
    ("vision cross prefill", (2, 64, 64, 128), (2, 1601, 8, 128)),
    ("Dh 16, 8 keys", (3, 5, 4, 16), (3, 8, 1, 16)),
    ("whole keys, Dh 128", (2, 40, 8, 128), (2, 50, 8, 128)),
    ("vision cross decode", (2, 1, 64, 128), (2, 1601, 8, 128)),
    ("whisper cross decode", (4, 1, 8, 64), (4, 1500, 8, 64)),
    ("Dh 16, 33 keys", (3, 1, 4, 16), (3, 33, 1, 16)),
    ("decode GQA 8:1, 65 keys", (1, 1, 8, 64), (1, 65, 1, 64)),
    ("decode 32 heads a group", (2, 1, 32, 128), (2, 100, 1, 128)),
)


def check_flash_attention_noncausal(torch, dev):
    """The non-causal bf16 kernels through the wrapper at
    ``MM_NONCAUSAL_CASES`` (``flash_decode_bf16`` for one query row,
    ``flash_prefill_bf16`` for more, each with ``causal`` 0 and counted
    under its non-causal form in ``backend.FORMS``) against the plain
    version
    (``attention_noncausal_plain``): o within one bf16 ulp of the largest
    plain element (both round fp32 sums taken in another order to bf16),
    two calls bitwise equal, each call one launch of its form. Returns one
    entry per form, each case's numbers under ``cases``, the first case's
    as the entry's."""
    import torch.nn.functional as F
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import (
        attention_noncausal_plain, flash_attention)
    from repro_torch.kernels.flash_attention import ops as FA
    g = torch.Generator().manual_seed(12)
    cases = {form: [] for form in FA.NONCAUSAL_FORMS.values()}
    for label, q_shape, kv_shape in MM_NONCAUSAL_CASES:
        B, Nq, Hq, Dh = q_shape
        Nk, KV = kv_shape[1], kv_shape[2]
        q = torch.randn(q_shape, generator=g).to(dev, torch.bfloat16)
        k, v = (torch.randn(kv_shape, generator=g).to(dev, torch.bfloat16)
                for _ in range(2))
        decode = Nq == 1
        name = FA.NONCAUSAL_FORMS[decode]

        def kern(q=q, k=k, v=v):
            return flash_attention(q, k, v)

        def plain(q=q, k=k, v=v):
            return attention_noncausal_plain(q, k, v)

        before, forms = backend.launches(), backend.form_launches()
        o, again, ref = kern(), kern(), plain()
        torch.cuda.synchronize()
        require(backend.form_launches()[name] == forms[name] + 2
                and sum(backend.launches().values())
                == sum(before.values()) + 2,
                f"non-causal attention ({label}) did not launch {name} "
                f"once a call")
        require(torch.equal(o, again),
                f"{name} ({label}): two launches on the same inputs differ")
        require(o.dtype == torch.bfloat16 and o.shape == q.shape
                and bool(torch.isfinite(o.float()).all()),
                f"{name} ({label}): output {o.dtype} {tuple(o.shape)} or "
                f"not finite")
        errs = [(f"o ({label})", (o.float() - ref.float()).abs().max().item(),
                 BF16_ULP * ref.float().abs().max().item(),
                 "one bf16 ulp at max|plain|")]
        # the work, counted as for the causal forms: every (row, head, key)
        # pair takes 2 Dh operations for Q.K and 2 Dh for P.V at the bf16
        # rate (not the kernels' split of P into two bf16 halves) and ~4
        # for the softmax; bytes: q and o once, k and v once
        pairs = B * Hq * Nq * Nk
        n_bytes = 2 * 2 * q.numel() + 2 * 2 * k.numel()
        bnd, by = bound_ms(n_bytes, 4 * pairs, 4 * Dh * pairs)
        qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))

        def library(qh=qh, kh=kh, vh=vh):
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  enable_gqa=True)

        cases[name].append(dict(
            label=label, errs=errs, fn=kern, ms=time_ms(kern),
            plain_ms=time_ms(plain), library_fn=library,
            library_ms=time_ms(library), bound_ms=bnd, bound_by=by,
            shapes=f"q[{B},{Nq},{Hq},{Dh}] k,v[{B},{Nk},{KV},{Dh}] bf16 "
                   f"non-causal"))
    checks = []
    for name, cs in cases.items():
        head = cs[0]
        checks.append(dict(
            name=name, source=f"{backend.FORMS[name][:-5]}.cu",
            errs=[e for c in cs for e in c["errs"]], fn=head["fn"],
            ms=head["ms"], plain_ms=head["plain_ms"],
            library_fn=head["library_fn"], library_ms=head["library_ms"],
            library_call="F.scaled_dot_product_attention(enable_gqa=True) "
                         "on bf16, no mask",
            bound_ms=head["bound_ms"], bound_by=head["bound_by"],
            shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cs),
            cases=cs))
    return checks


def _tdm_scores(torch, dev, g, B, N, n_valid, ties=False):
    """Scores of a token-padded TDM tile: random, or with ``ties`` a few
    distinct levels (integers in [0, 3) / 8, so most rows tie); padded
    rows score exactly 0."""
    s = (torch.randint(0, 3, (B, N), generator=g).float() / 8 if ties
         else torch.rand((B, N), generator=g))
    for bi, nv in enumerate(n_valid):
        s[bi, nv:] = 0.0  # token-padded rows score exactly 0
    return (s if ties else s / s.sum(dim=1, keepdim=True)).to(dev)


def check_token_drop(torch, dev):
    """The hard TDM at the main path's shape (z [4, 197, 384], k = 138,
    rows with 197, 180, 160 and 140 real tokens) on random and on
    tie-heavy scores: CLS and kept rows bitwise the plain version's, the
    fused row within 1e-5, and each row computed alone (its real tokens
    only) bitwise equal to its row of the padded tile; timed on the random
    scores."""
    from repro_torch.kernels.token_drop import token_drop, token_drop_plain
    B, N, D, k = 4, 197, 384, 138
    n_valid = (197, 180, 160, 140)
    g = torch.Generator().manual_seed(3)
    z = torch.randn((B, N, D), generator=g).to(dev)
    errs = []
    for ties in (True, False):
        scores = _tdm_scores(torch, dev, g, B, N, n_valid, ties)
        label = " (tie-heavy)" if ties else ""
        out, ref = token_drop(z, scores, k), token_drop_plain(z, scores, k)
        torch.cuda.synchronize()
        require(torch.equal(out[:, :k + 1], ref[:, :k + 1]),
                f"token_drop{label}: CLS/kept rows differ from the plain "
                f"version")
        for bi, nv in enumerate(n_valid):
            one = token_drop(z[bi:bi + 1, :nv].contiguous(),
                             scores[bi:bi + 1, :nv], k)
            require(torch.equal(one[0], out[bi]),
                    f"token_drop{label}: row {bi} alone ({nv} tokens) "
                    f"differs bitwise from its row of the padded tile")
        errs.append(("fused row" + label,
                     (out[:, k + 1] - ref[:, k + 1]).abs().max().item(),
                     1e-5, "kept rows bitwise"))
    n_bytes = 4 * (z.numel() + scores.numel() + B * (k + 2) * D)
    bnd, by = bound_ms(n_bytes, 2 * B * (N - 1) * D)
    return dict(
        name="token_drop_f32", source="token_drop.cu", errs=errs,
        fn=lambda: token_drop(z, scores, k),
        ms=time_ms(lambda: token_drop(z, scores, k)),
        plain_ms=time_ms(lambda: token_drop_plain(z, scores, k)),
        library_fn=None, library_ms=None, library_call=None,
        bound_ms=bnd, bound_by=by,
        shapes=f"z[{B},{N},{D}] k={k} n_valid={list(n_valid)}, random and "
               f"tie-heavy scores; rows bitwise alone")


def check_token_package(torch, dev):
    """The soft TDM at the main path's first soft TDM (z [4, 197, 384],
    k = 138, no package yet) and at a later one (a token-padded tile of
    rows with 140, 120, 100 and 72 real tokens, the package of each at its
    own body index n_valid - 2 as the engine passes it, int32, carried
    masses, k = 70), each on random and on tie-heavy scores (the latter
    with int64 package positions anywhere in a row: 0, mid-row, and
    n_valid - 2); timed at the later one on random scores."""
    from repro_torch.kernels.token_package import (token_package,
                                                   token_package_plain)
    g = torch.Generator().manual_seed(4)
    D = 384
    cases = []
    for B, N, k, n_valid, has_pkg in ((4, 197, 138, (197, 180, 160, 140),
                                       False),
                                      (4, 140, 70, (140, 120, 100, 72),
                                       True)):
        z = torch.randn((B, N, D), generator=g).to(dev)
        for ties in (True, False):
            scores = _tdm_scores(torch, dev, g, B, N, n_valid, ties)
            mass = pos = None
            if has_pkg:
                mass = torch.rand((B,), generator=g).to(dev)
                pos = (torch.tensor((0, 50, 31, n_valid[3] - 2), device=dev)
                       if ties else torch.tensor(
                           [n - 2 for n in n_valid], dtype=torch.int32,
                           device=dev))
            out, m = token_package(z, scores, k, mass, pos)
            ref, m_ref = token_package_plain(z, scores, k, mass, pos)
            torch.cuda.synchronize()
            require(torch.equal(out[:, :k + 1], ref[:, :k + 1]),
                    "token_package: CLS/kept rows differ from the plain "
                    "version" + (" (tie-heavy)" if ties else ""))
            cases.append(((out[:, k + 1] - ref[:, k + 1]).abs().max().item(),
                          (m - m_ref).abs().max().item()))
    n_bytes = 4 * (z.numel() + scores.numel() + B * (k + 2) * D + 3 * B)
    bnd, by = bound_ms(n_bytes, 2 * B * (N - 1) * D + B * (N - 1))
    return dict(
        name="token_package_f32", source="token_package.cu",
        errs=[("package row", max(c[0] for c in cases), 1e-5,
               "kept rows bitwise"),
              ("new_mass", max(c[1] for c in cases), 1e-5, "")],
        fn=lambda: token_package(z, scores, k, mass, pos),
        ms=time_ms(lambda: token_package(z, scores, k, mass, pos)),
        plain_ms=time_ms(lambda: token_package_plain(z, scores, k, mass,
                                                     pos)),
        library_fn=None, library_ms=None, library_call=None,
        bound_ms=bnd, bound_by=by,
        shapes=f"z[4,197,{D}] k=138 (first); z[{B},{N},{D}] k={k} "
               f"n_valid={list(n_valid)} with package (timed); random and "
               f"tie-heavy scores")


# ---------------------------------------------------------------------------
# Phase 4: main path
# ---------------------------------------------------------------------------
REPEATS = 5       # timed serves of the fp32 stream per pipeline depth
TIER_REPEATS = 3  # timed serves of each tier's soft stream
# the entry points each serving path must launch in every serve
PATH_KERNELS = {
    "fp32": ("sbmm_f32", "flash_attention_f32", "token_drop_f32"),
    "fp16": ("sbmm_f16w", "flash_attention_f16", "token_drop_f32",
             "token_package_f32"),
    "int8": ("sbmm_i8_channel", "flash_attention_f32", "token_drop_f32",
             "token_package_f32"),
    "int8-block": ("sbmm_i8_block", "flash_attention_f32", "token_drop_f32",
                   "token_package_f32"),
}
TIERS = (("fp16", "fp16", "channel"), ("int8", "int8", "channel"),
         ("int8-block", "int8", "block"))  # (path, precision, granularity)


def make_engine(cfg, params, scores, depth, dev, tracer=None,
                precision="fp32", granularity="channel"):
    from repro_torch.serving.vision import VisionEngine, VisionEngineConfig
    return VisionEngine.from_pruned(
        cfg, params, scores, device=dev, tracer=tracer,
        vc=VisionEngineConfig(max_batch=4, planner="full",
                              pipeline_depth=depth, precision=precision,
                              quant_granularity=granularity))


PIPE_KEYS = ("steps", "pipeline_block_s", "pipeline_dispatch_s",
             "pipeline_overlap_hits", "dispatch_fp32", "dispatch_fp16",
             "dispatch_int8", "dequant_dispatches", "plan_precision_fp32",
             "plan_precision_fp16", "plan_precision_int8")


def timed_window(torch, backend, fn):
    """Run ``fn()`` as one measured window on the card: launch counts set
    to 0 just before and read just after, the host's waits on the card
    besides the pipelines' step events (blocking copies, ``.item()``)
    counted by PyTorch's sync debug mode. Returns (``fn``'s result, wall
    seconds, launch counts, host syncs)."""
    torch.cuda.synchronize()
    backend.reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            result = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    syncs = sum("synchronizing CUDA operation" in str(w.message)
                for w in caught)
    return result, dt, backend.launches(), syncs


def serve_stream(torch, backend, eng, soft=False):
    """Serve the 16-request stream once on ``eng`` (with ``soft``, every
    other request soft-pruned): launch counts set to 0 just before and
    read just after; the host's waits on the card other than the
    pipeline's events (blocking copies, ``.item()``) counted by PyTorch's
    sync debug mode. Returns (requests, {uid: logits}, wall seconds,
    launch counts, {engine steps, pipeline block / dispatch seconds and
    overlap hits, dispatches and admissions per precision, and
    ``host_syncs``, of this serve})."""
    from repro_torch.launch.serve_vision import make_requests
    reqs = make_requests(eng.cfg, 16, arrival_spread=4, seed=0)
    for r in reqs:
        r.soft_prune = soft and r.uid % 2 == 0
    before = eng.stats()
    out, dt, counts, syncs = timed_window(torch, backend,
                                          lambda: eng.serve(reqs))
    after = eng.stats()
    pipe = {k: after[k] - before[k] for k in PIPE_KEYS}
    pipe["host_syncs"] = syncs
    return reqs, out, dt, counts, pipe


# engine vs offline oracle, relative to max(1, |ref|), per tier. The fp32
# and int8 tiers keep fp32 activations: the engine differs from the
# unbatched oracle only where cuBLAS picks another algorithm for another
# row count (1.0e-6 measured). At fp16 such differences can flip the fp16
# rounding of q/k/v elements and attention outputs (one fp16 ulp is up to
# ~1e-3 relative to the element) and the flips carry through the later
# layers: the engine measured 2.19e-4, so the tier is held to 5e-4.
# ``rounding_witness`` measures the same effect on the oracle alone.
ORACLE_TOL = {"fp32": 1e-4, "int8": 1e-4, "fp16": 5e-4}


def check_against_oracle(torch, cfg, eng, reqs, out, precision, label):
    """Every request against the offline forward at its soft flag and the
    path's tier: ``ORACLE_TOL`` relative to max(1, |ref|), top-1 equal.
    Returns the largest relative difference."""
    import numpy as np
    from repro_torch.core import packed_runner as PR
    tol = ORACLE_TOL[precision]
    worst = 0.0
    for r in reqs:
        require(out[r.uid].shape == (cfg.num_classes,)
                and bool(np.isfinite(out[r.uid]).all()),
                f"{label}: uid {r.uid} logits not finite/shaped")
        ref = PR.forward_vit_packed(
            cfg, eng.segments.params, eng.segments.packed, r.patches[None],
            segments=eng.segments, soft=r.soft_prune, precision=precision,
            schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
        ref = ref.cpu().numpy()
        err = float(np.abs(out[r.uid] - ref).max())
        scale = max(1.0, float(np.abs(ref).max()))
        worst = max(worst, err / scale)
        require(err <= tol * scale, f"{label}: uid {r.uid}: engine vs "
                                    f"offline oracle max|d|={err:.3g} > "
                                    f"{tol}*{scale:.3g}")
        require(int(np.argmax(out[r.uid])) == int(np.argmax(ref)),
                f"{label}: uid {r.uid}: top-1 differs from the offline "
                f"oracle")
    print(f"{label}: engine vs offline forward_vit_packed: top-1 "
          f"{len(reqs)}/{len(reqs)} equal, max|d|/max(1,max|ref|) = "
          f"{worst:.3g} (tolerance {tol})", flush=True)
    return worst


def rounding_witness(torch, cfg, eng, reqs, precision, label):
    """How far the offline oracle alone moves when a random half of its
    input elements move by one fp32 ulp, the size of a change of
    summation order: at ``precision`` and at fp32, relative to max(1,
    |ref|), each request at its soft flag. Printed, not checked."""
    import numpy as np
    from repro_torch.core import packed_runner as PR
    rng = np.random.default_rng(5)
    moved = {}
    for prec in (precision, "fp32"):
        worst = 0.0
        for r in reqs:
            x = r.patches[None]
            x_ulp = np.where(rng.random(x.shape) < 0.5,
                             np.nextafter(x, np.float32(np.inf)), x)
            ys = [PR.forward_vit_packed(
                cfg, eng.segments.params, eng.segments.packed, xi,
                segments=eng.segments, soft=r.soft_prune, precision=prec,
                schedule=PR.keep_schedule(cfg, r_t=r.r_t)).logits[0]
                for xi in (x, x_ulp)]
            err = (ys[1] - ys[0]).abs().max().item()
            worst = max(worst, err / max(1.0, ys[0].abs().max().item()))
        moved[prec] = worst
    print(f"{label}: offline oracle moved by one fp32 ulp on half its "
          f"inputs: max|d|/max(1,max|ref|) = {moved[precision]:.3g} at "
          f"{precision}, {moved['fp32']:.3g} at fp32", flush=True)
    return moved


def require_launched(counts, path, label):
    for name in PATH_KERNELS[path]:
        require(counts[name] > 0, f"{label}: kernel {name} never launched "
                                  f"on the {path} path")


def print_serve(label, out, walls, counts, syncs, pipe):
    dt = statistics.median(walls)
    steps = pipe["steps"]
    print(f"{label}: {len(out)} images, {steps} steps; wall over "
          f"{len(walls)} serves median {dt:.4f} s (min {min(walls):.4f}, "
          f"max {max(walls):.4f}): {len(out) / dt:.2f} images/s, "
          f"{dt / steps * 1e3:.3f} ms/step; launches per serve="
          f"{ {k: v for k, v in counts.items() if v} }; host syncs besides "
          f"the step events per serve (warm-up first)={syncs}; last serve: "
          f"dispatch {pipe['pipeline_dispatch_s'] * 1e3:.2f} ms, block on "
          f"events {pipe['pipeline_block_s'] * 1e3:.2f} ms, "
          f"{pipe['pipeline_overlap_hits']}/{steps} steps done before their "
          f"completion; dispatches fp32/fp16/int8 "
          f"{pipe['dispatch_fp32']}/{pipe['dispatch_fp16']}/"
          f"{pipe['dispatch_int8']}, dequant {pipe['dequant_dispatches']}",
          flush=True)
    return dt


def main_path(torch, dev):
    """Returns ({path: launch counts of its last timed serve}, {path: host
    syncs per serve}, the model, {path: median wall of its serves})."""
    import numpy as np
    from repro_torch.configs import DEIT_SMALL
    from repro_torch.core import packed_runner as PR
    from repro_torch.kernels import backend
    from repro_torch.models import model as M
    from repro_torch.models import pruning_glue as PG

    cfg = DEIT_SMALL
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=dev)
    scores = PG.init_scores(cfg, params, torch.Generator().manual_seed(7))
    runs, syncs, path_counts, walls_by = {}, {}, {}, {}
    # (a) fp32, hard TDM, pipeline depths 1 and 2
    for depth in (1, 2):
        eng = make_engine(cfg, params, scores, depth, dev)
        key = f"fp32 depth {depth}"
        syncs[key] = [serve_stream(torch, backend, eng)[4]["host_syncs"]]
        walls = []  # warm-up serve above
        for _ in range(REPEATS):
            reqs, out, dt, counts, pipe = serve_stream(torch, backend, eng)
            require(sorted(out) == [r.uid for r in reqs],
                    f"{key}: not every request was served")
            require_launched(counts, "fp32", key)
            walls.append(dt)
            syncs[key].append(pipe["host_syncs"])
        walls_by[key] = print_serve(f"main path {key}", out, walls, counts,
                                    syncs[key], pipe)
        runs[depth] = (eng, reqs, out)
        if depth == 1:
            path_counts["fp32"] = counts

    eng, reqs, out = runs[1]
    check_against_oracle(torch, cfg, eng, reqs, out, "fp32", "fp32 depth 1")
    out2 = runs[2][2]
    d12 = max(float(np.abs(out[u] - out2[u]).max()) for u in out)
    require(d12 <= 1e-5, f"depth 1 vs 2: max|d|={d12:.3g} > 1e-5")
    require(all(int(np.argmax(out[u])) == int(np.argmax(out2[u]))
                for u in out), "depth 1 vs 2: top-1 differs")
    print(f"depth 1 vs depth 2: top-1 16/16 equal, max|d| = {d12:.3g} "
          f"(tolerance 1e-5)", flush=True)

    # kernels against the plain masked-dense model, token pruning off (no
    # top-k, so no near-tie can flip a selection between the two)
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, n_patches, cfg.patch_size ** 2 * 3)),
        dtype=torch.float32).to(dev)
    y = PR.forward_vit_packed(cfg, eng.segments.params, eng.segments.packed,
                              x, use_tdm=False, device=dev).logits
    y_ref = masked_dense_on_cpu(cfg, params, scores, x)
    y = y.cpu()
    err = (y - y_ref).abs().max().item()
    scale = max(1.0, y_ref.abs().max().item())
    require(err <= 1e-4 * scale, f"packed vs masked-dense: max|d|={err:.3g}")
    require(bool((y.argmax(-1) == y_ref.argmax(-1)).all()),
            "packed vs masked-dense: top-1 differs")
    print(f"packed (kernels) vs masked-dense (plain, on the CPU), no TDM: "
          f"max|d| = {err:.3g} (tolerance 1e-4 x {scale:.3g})", flush=True)

    # (b) the fp16 and int8 tiers, every other request soft-pruned
    for path, precision, granularity in TIERS:
        eng = make_engine(cfg, params, scores, 1, dev, precision=precision,
                          granularity=granularity)
        key = f"{path} soft"
        syncs[key] = [serve_stream(torch, backend, eng,
                                   soft=True)[4]["host_syncs"]]
        walls = []
        for _ in range(TIER_REPEATS):
            reqs, out, dt, counts, pipe = serve_stream(torch, backend, eng,
                                                       soft=True)
            require(sorted(out) == [r.uid for r in reqs],
                    f"{key}: not every request was served")
            require_launched(counts, path, key)
            require(pipe[f"plan_precision_{precision}"] == len(reqs),
                    f"{key}: {pipe[f'plan_precision_{precision}']} of "
                    f"{len(reqs)} requests admitted at {precision}")
            require(pipe[f"dispatch_{precision}"] > 0,
                    f"{key}: no dispatch at {precision}")
            require((pipe["dequant_dispatches"] > 0) == (precision == "int8"),
                    f"{key}: dequant dispatches "
                    f"{pipe['dequant_dispatches']}")
            walls.append(dt)
            syncs[key].append(pipe["host_syncs"])
        walls_by[key] = print_serve(f"main path {key}", out, walls, counts,
                                    syncs[key], pipe)
        check_against_oracle(torch, cfg, eng, reqs, out, precision, key)
        if precision == "fp16":
            rounding_witness(torch, cfg, eng, reqs, precision, key)
        path_counts[path] = counts
    return path_counts, syncs, (cfg, params, scores, walls_by)


# ---------------------------------------------------------------------------
# Phase 4, LM: full-width Minitron-4B through ServeEngine
# ---------------------------------------------------------------------------
LM_PROMPTS = (96, 200, 384, 500)  # prompt lengths, twice over: 8 requests
# The profiled serves of Minitron-4B and Granite-MoE run the first 8 of
# their 32 layers: a full-depth serve's profile (~200,000 and ~300,000
# kernel records, with their launches and host operators) took 192 s and
# 95 s of the script's time limit, most of it the profiler's parse
PROFILE_LAYERS = 8
LM_MAX_NEW, LM_MAX_BATCH, LM_MAX_LEN = 32, 4, 572
LM_REPEATS = 2    # timed serves of each LM path, in turns after warm-ups
# (label, continuous, EngineConfig overrides); the teacher-forced oracle
# holds the unpruned serves (pruning changes the function it computes)
LM_SERVES = (
    ("continuous depth 1", True, {}),
    ("continuous depth 2", True, dict(pipeline_depth=2)),
    ("continuous kv-prune", True, dict(kv_prune_keep=0.5,
                                       kv_prune_interval=4)),
    ("static waves", False, {}),
)
# the engine's token against the offline forward (no cache, B=1), per
# generated token: the largest logit at that position minus the logit of
# the engine's token. The engine batches 4 rows and reads a KV cache where
# the forward runs one 600-token sequence, so cuBLAS picks other bf16
# GEMMs and a rounding can flip; a wrong cache row, mask or RoPE phase
# would leave the engine's tokens near random (gaps of ~0.7 at this
# model's logit scale). 0.05 is the CPU bound of the port against the
# reference at bf16 (tests/test_torch_lm.py).
LM_ORACLE_TOL = 0.05
LM_KEYS = ("runner_prefill_calls", "runner_prefill_slot_calls",
           "runner_decode_calls", "prune_events", "pipeline_steps",
           "pipeline_block_s", "admissions")


def lm_requests(cfg):
    import numpy as np
    from repro_torch.serving import Request
    rng = np.random.default_rng(0)
    return [Request(uid=i, prompt=rng.integers(0, cfg.vocab_size, n)
                    .astype(np.int32), max_new_tokens=LM_MAX_NEW)
            for i, n in enumerate(LM_PROMPTS * 2)]


def serve_lm(torch, backend, eng, continuous):
    """Serve the 8-request stream once on ``eng``, launch counts set to 0
    just before and read just after, host waits besides the step events
    counted by PyTorch's sync debug mode. Returns (requests, outputs,
    wall seconds, launch counts, this serve's deltas of ``LM_KEYS`` plus
    ``host_syncs``)."""
    reqs = lm_requests(eng.cfg)
    before = eng.stats()
    out, dt, counts, syncs = timed_window(
        torch, backend, lambda: eng.serve(reqs, continuous=continuous))
    after = eng.stats()
    st = {k: after[k] - before[k] for k in LM_KEYS}
    st["host_syncs"] = syncs
    return reqs, out, dt, counts, st


def token_gaps(torch, logits, generated, dev):
    """For logits [n, V] at the positions of ``generated`` (n tokens): the
    largest gap between a position's largest logit and its token's, and
    how many tokens are the exact argmax."""
    gen = torch.tensor(generated, device=dev)
    gap = logits.max(dim=1).values - logits.gather(1, gen[:, None])[:, 0]
    return gap.max().item(), int((gap == 0).sum().item())


def check_lm_oracle(torch, cfg, params, reqs, dev, label):
    """The teacher-forced oracle: for each request, ``forward_lm`` over the
    prompt plus the engine's tokens (no cache, B=1, ``logits_for="all"``);
    each engine token's logit within ``LM_ORACLE_TOL`` of its position's
    largest. Prints the share of exact argmax matches."""
    import numpy as np
    from repro_torch.models import model as M
    worst, exact, n = 0.0, 0, 0
    for r in reqs:
        seq = np.concatenate([r.prompt, r.generated[:-1]]).astype(np.int64)
        with torch.no_grad():
            logits = M.forward_lm(cfg, params, torch.from_numpy(seq)[None].to(
                dev), logits_for="all").logits[0, len(r.prompt) - 1:]
        w, e = token_gaps(torch, logits, r.generated, dev)
        worst, exact, n = max(worst, w), exact + e, n + len(r.generated)
    require(worst <= LM_ORACLE_TOL,
            f"{label}: an engine token's oracle logit lies {worst:.4g} below "
            f"its position's largest (tolerance {LM_ORACLE_TOL})")
    print(f"{label}: teacher-forced oracle: {exact}/{n} tokens the exact "
          f"argmax ({exact / n:.3f}), largest gap {worst:.4g} (tolerance "
          f"{LM_ORACLE_TOL})", flush=True)
    return worst, exact / n


def lm_engine(cfg, params, dev, tracer=None, **kw):
    from repro_torch.serving import EngineConfig, ServeEngine
    return ServeEngine(cfg, params, EngineConfig(
        max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN, **kw), tracer=tracer,
        device=dev)


def run_lm_serves(torch, dev, cfg, params, tag, serves=LM_SERVES,
                  repeats=LM_REPEATS, warm=True, attn_layers=None,
                  scan=None):
    """Every serve of ``serves`` on its own engine over ``params``: each
    warmed up once (with ``warm``), then ``repeats`` timed serves in turns
    (so the paths share the host's load alike). Gates: every request gets
    ``LM_MAX_NEW`` tokens; the decode kernel launches once per attention
    layer (``attn_layers``, all layers by default) of every decode call
    and the prefill kernel once per attention layer of every prefill call;
    with ``scan`` (entry point, layers), that kernel once per such layer
    of every call; every path launches; a pruned serve prunes; depths 1
    and 2 give the same tokens. Prints each serve's numbers under ``tag``.
    Returns ({serve: (requests, outputs, launch counts, stats, warm-up
    spans, engine) of its last timed serve}, {serve: median wall},
    {serve: host syncs per serve})."""
    from repro_torch.kernels import backend
    from repro_torch.obs import Tracer
    engines, tracers, syncs, walls, last = {}, {}, {}, {}, {}
    for label, continuous, kw in serves:
        tracers[label] = Tracer()
        engines[label] = lm_engine(cfg, params, dev, tracer=tracers[label],
                                   **kw)
        syncs[label] = ([serve_lm(torch, backend, engines[label],
                                  continuous)[4]["host_syncs"]]
                        if warm else [])
        walls[label] = []
    for _ in range(repeats):
        for label, continuous, kw in serves:
            n_warm = len(tracers[label].span_log)
            reqs, out, dt, counts, st = serve_lm(torch, backend,
                                                 engines[label], continuous)
            walls[label].append(dt)
            syncs[label].append(st["host_syncs"])
            require(sorted(out) == list(range(len(reqs)))
                    and all(len(t) == LM_MAX_NEW for t in out.values()),
                    f"{tag} {label}: not every request got {LM_MAX_NEW} "
                    f"tokens")
            calls = (st["runner_prefill_calls"]
                     + st["runner_prefill_slot_calls"])
            require(calls > 0 and st["runner_decode_calls"] > 0,
                    f"{tag} {label}: prefill or decode never ran: {st}")
            n_dec = counts["flash_decode_bf16"]
            n_pre = counts["flash_prefill_bf16"]
            n_attn = cfg.num_layers if attn_layers is None else attn_layers
            require(n_dec == n_attn * st["runner_decode_calls"]
                    and n_pre == n_attn * calls,
                    f"{tag} {label}: flash_decode_bf16 / flash_prefill_bf16 "
                    f"launched {n_dec} / {n_pre} times, not once per "
                    f"attention layer of every decode / prefill call "
                    f"({n_attn * st['runner_decode_calls']} / "
                    f"{n_attn * calls})")
            if scan is not None:
                entry, n_layers = scan
                n_scan = counts[entry]
                want = n_layers * (calls + st["runner_decode_calls"])
                require(n_scan == want > 0,
                        f"{tag} {label}: {entry} launched {n_scan} times, "
                        f"not once per recurrent layer of every call "
                        f"({want})")
            if kw.get("kv_prune_keep", 1.0) < 1.0:
                require(st["prune_events"] >= 1,
                        f"{tag} {label}: no KV prune fired")
            last[label] = (reqs, out, counts, st, n_warm, engines[label])
    walls_by = {}
    for label, continuous, _ in serves:
        reqs, out, counts, st, n_warm, _ = last[label]
        wall = statistics.median(walls[label])
        calls = st["runner_prefill_calls"] + st["runner_prefill_slot_calls"]
        steps = (st["pipeline_steps"] if continuous
                 else calls + st["runner_decode_calls"])
        dec = [sp for sp in tracers[label].span_log[n_warm:]
               if sp["attrs"].get("label") == "lm-decode"]
        dec_ms = (sum(sp["dur_ms"] for sp in dec) / st["runner_decode_calls"]
                  if dec else float("nan"))
        n_tok = sum(len(t) for t in out.values())
        print(f"{tag} {label}: {len(out)} requests x {LM_MAX_NEW} tokens, "
              f"{steps} steps ({calls} prefill calls, "
              f"{st['runner_decode_calls']} decode steps); wall over "
              f"{len(walls[label])} serves "
              f"{[round(w, 4) for w in walls[label]]} median {wall:.4f} s: "
              f"{n_tok / wall:.2f} tokens/s, "
              f"{wall / steps * 1e3:.3f} ms/step; decode step dispatch + "
              f"completion {dec_ms:.3f} ms (pipeline spans; a step latency "
              f"at depth 1 only), block on step events "
              f"{st['pipeline_block_s'] * 1e3:.2f} ms in all; prune events "
              f"{st['prune_events']}; kernel launches decode / prefill "
              f"{counts['flash_decode_bf16']} / "
              f"{counts['flash_prefill_bf16']}"
              + (f", {scan[0]} {counts[scan[0]]}" if scan else "")
              + f"; host syncs besides "
              f"the step events per serve"
              f"{' (warm-up first)' if warm else ''}={syncs[label]}",
              flush=True)
        walls_by[label] = wall
    labels = [label for label, _, _ in serves]
    if "continuous depth 2" in labels:
        require(last["continuous depth 1"][1] == last["continuous depth 2"][1],
                f"{tag}: depth 1 and depth 2 gave different tokens")
        print(f"{tag}: depth 1 and depth 2 tokens identical "
              f"({len(last['continuous depth 1'][1])} requests)", flush=True)
    return last, walls_by, syncs


def lm_path(torch, dev):
    """Full-width Minitron-4B (random weights from seed 0, drawn on the
    card; the serving copy holds its matrices in bf16) serving 8 requests
    on each of ``LM_SERVES`` (``run_lm_serves``), then the teacher-forced
    oracle. Returns ({"lm": launch counts of the last timed depth-1
    serve}, {serve: host syncs per serve}, (cfg, params))."""
    from repro_torch.configs import MINITRON_4B
    from repro_torch.models import model as M
    from repro_torch.serving.runner import serving_params
    from repro_torch.tree import leaves
    cfg = MINITRON_4B
    t0 = time.perf_counter()
    params = serving_params(cfg, M.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"lm: {cfg.name} at full width and depth ({cfg.num_layers} layers, "
          f"D={cfg.d_model}, {cfg.num_heads} query / {cfg.num_kv_heads} KV "
          f"heads, Dh={cfg.head_dim}, vocab {cfg.vocab_size}), "
          f"{n_params / 1e9:.3f} B params, bf16 serving copy made in "
          f"{time.perf_counter() - t0:.2f} s; "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated",
          flush=True)
    last, _, syncs = run_lm_serves(torch, dev, cfg, params, "lm")
    for label in ("continuous depth 1", "static waves"):
        check_lm_oracle(torch, cfg, params, last[label][0], dev,
                        f"lm {label}")
    step = decode_step_alone(torch, dev, cfg, params)
    step_ms = time_ms(step, samples=5, calls=5, warmup=2)
    print(f"lm: one decode step alone (B=4, 572-slot cache, windows of "
          f"{LM_DECODE[4]} keys): {step_ms:.3f} ms", flush=True)
    return ({"lm": last["continuous depth 1"][2]}, syncs,
            (cfg, params))


def decode_step_alone(torch, dev, cfg, params):
    """One batch-4 decode step of the engine's runner, as a closure: every
    live slot of a 572-slot cache at the decode check's lengths."""
    from repro_torch.models import steps as ST
    eng = lm_engine(cfg, params, dev)
    caches = ST.init_caches(cfg, LM_MAX_BATCH, LM_MAX_LEN, device=dev)
    lens = torch.tensor(LM_DECODE[4], dtype=torch.int32, device=dev) - 1
    caches = [c._replace(length=lens.clone()) for c in caches]
    starts = torch.tensor(LM_DECODE[5], dtype=torch.int32, device=dev)
    toks = torch.zeros((LM_MAX_BATCH,), dtype=torch.int64, device=dev)
    return lambda: eng.runner.decode(toks, caches, starts)


# ---------------------------------------------------------------------------
# Phase 4d, MoE: full-width Granite-MoE-3B-A800M through ServeEngine
# ---------------------------------------------------------------------------
# timed serves of each Granite-MoE path after its warm-up: one, not
# ``LM_REPEATS``, to keep the script's total near 700 s once MoE training
# runs (its phase adds ~60 s)
MOE_REPEATS = 1
MOE_QWEN_LAYERS = 4  # of Qwen2-MoE-A2.7B's 24: its fp32 draw and bf16 copy
#                      at full depth (53.3 + 26.7 GiB) do not fit 80 GB


def check_moe_call_oracle(torch, cfg, params, reqs, dev, label):
    """The call-for-call oracle of a continuous MoE serve. Each request goes
    alone through its per-slot prefill's own call (``forward_lm`` prefill
    at B=1 into a blank 572-slot cache, at the engine's bucket and
    ``valid_start``: ``make_prefill_slot`` runs this call, so its capacity
    and drops are the engine's), its cache row then written into a
    batch of all the requests, which is teacher-forced through decode
    calls fed the engine's tokens (C = 8 >= B for B <= 8, as at the
    engine's B=4: a decode drops nothing, so each row is computed as
    alone). Each engine token's logit within ``LM_ORACLE_TOL`` of its
    position's largest. The teacher-forced oracle of ``check_lm_oracle``
    runs one call over all tokens, whose capacity and drops differ: its
    gap would be routing, not error. Also counts, per prefill call, the
    real (token, expert) pairs the capacity dropped, summed over layers,
    beside the real pairs routed (``moe.route`` wrapped for the call), and
    the call's load-balancing loss per layer (1 when every expert gets its
    share, up to E when all tokens pick the same k experts). Returns
    (dropped, routed, aux per layer) per prefill call."""
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models import steps as ST
    from repro_torch.serving import EngineConfig
    from repro_torch.serving.cache_manager import KVCacheManager
    ec = EngineConfig(max_batch=LM_MAX_BATCH, max_len=LM_MAX_LEN)
    require(len(reqs) <= 8 and len({len(r.generated) for r in reqs}) == 1,
            f"{label}: the oracle decodes all requests together (at most "
            f"8, each with as many tokens)")
    route, drops = MOE.route, []
    batch = ST.init_caches(cfg, len(reqs), LM_MAX_LEN, device=dev)
    starts, logits = [], []
    with torch.no_grad():
        for slot, r in enumerate(reqs):
            P = len(r.prompt)
            lb, start = KVCacheManager(cfg, ec, device=dev).admit(
                0, P, r.max_new_tokens)
            row = torch.zeros((1, lb), dtype=torch.int32, device=dev)
            row[0, lb - P:] = torch.from_numpy(r.prompt).to(dev)
            real = (torch.arange(lb, device=dev) >= start)[:, None]
            counts = []

            def counted(xf, p, c, capacity_factor=None):
                rt = route(xf, p, c, capacity_factor)
                counts.append(torch.stack([(~rt.kept & real).sum(),
                                           real.sum() * rt.kept.shape[1]]))
                return rt
            MOE.route = counted
            try:
                out = M.forward_lm(
                    cfg, params, row, mode="prefill",
                    caches=ST.init_caches(cfg, 1, LM_MAX_LEN, device=dev),
                    logits_for="last", valid_start=torch.tensor(
                        [start], dtype=torch.int32, device=dev))
            finally:
                MOE.route = route
            drops.append(torch.cat([torch.stack(counts).sum(0).float(),
                                    (out.aux_loss / cfg.num_layers)[None]]))
            logits.append([out.logits[0, -1]])
            starts.append(start)
            for dst, src in zip(batch, out.caches):
                for d, one in zip(dst, src):
                    d[slot] = one[0]
        vs = torch.tensor(starts, dtype=torch.int32, device=dev)
        for i in range(len(reqs[0].generated) - 1):
            toks = torch.tensor([[r.generated[i]] for r in reqs],
                                dtype=torch.int32, device=dev)
            out = M.forward_lm(cfg, params, toks, mode="decode",
                               caches=batch, valid_start=vs)
            batch = out.caches
            for slot in range(len(reqs)):
                logits[slot].append(out.logits[slot, -1])
    worst, exact, n = 0.0, 0, 0
    for r, lg in zip(reqs, logits):
        w, e = token_gaps(torch, torch.stack(lg), r.generated, dev)
        worst, exact, n = max(worst, w), exact + e, n + len(r.generated)
    require(worst <= LM_ORACLE_TOL,
            f"{label}: an engine token's call-for-call oracle logit lies "
            f"{worst:.4g} below its position's largest (tolerance "
            f"{LM_ORACLE_TOL})")
    print(f"{label}: call-for-call oracle: {exact}/{n} tokens the exact "
          f"argmax ({exact / n:.3f}), largest gap {worst:.4g} (tolerance "
          f"{LM_ORACLE_TOL})", flush=True)
    return [d.tolist() for d in drops]


def lm_serve_params(torch, dev, cfg, tag):
    """``cfg``'s weights from seed 0 drawn on the card in fp32, then the
    bf16 serving copy (``serving_params``: RWKV6's ``u`` stays fp32); the
    fp32 draw is dropped once the copy exists. Prints the params, the
    copy's size and the peak while both lived."""
    from repro_torch.models import model as M
    from repro_torch.serving.runner import serving_params
    from repro_torch.tree import leaves
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    base = torch.cuda.memory_allocated(dev)
    t0 = time.perf_counter()
    params = serving_params(cfg, M.init_params(
        cfg, torch.Generator(dev).manual_seed(0), device=dev))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    n_bytes = sum(t.numel() * t.element_size() for t in leaves(params))
    moe = (f", {cfg.moe_num_experts} experts top-{cfg.moe_top_k}, d_ff "
           f"{cfg.d_ff}, shared d_ff "
           f"{cfg.moe_shared_d_ff or cfg.d_ff * cfg.moe_num_shared}"
           if cfg.family == "moe" else f", d_ff {cfg.d_ff}")
    print(f"{tag}: {cfg.name} ({cfg.family}, {cfg.num_layers} layers, "
          f"D={cfg.d_model}, {cfg.num_heads} query / {cfg.num_kv_heads} KV "
          f"heads, Dh={cfg.head_dim}{moe}, vocab {cfg.vocab_size}), "
          f"{n_params} params ({n_params / 1e9:.3f} B), bf16 serving copy "
          f"{n_bytes / 2 ** 30:.2f} GiB made in "
          f"{time.perf_counter() - t0:.2f} s; peak while the fp32 draw "
          f"lived {(torch.cuda.max_memory_allocated(dev) - base) / 2 ** 30:.2f}"
          f" GiB above the {base / 2 ** 30:.2f} GiB earlier phases hold; "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated "
          f"now", flush=True)
    return params


def profile_moe(torch, dev, cfg, params):
    """One continuous depth-1 MoE serve of ``profiled_engine`` profiled
    on the card's side only (kernel records: host operators would triple
    the trace): ``report_profile`` and the causal
    kernels' share of device busy. Then, at full depth, one batch-4 decode
    step alone (``decode_step_alone``): its wall (CUDA events), and, from
    2 steps profiled with host operators and a ``record_function`` range
    around each ``moe_ffn``, its device launches, its device time against
    the least the card could take (the bytes of every weight the step
    reads, all but the embedding table, of which it reads 4 rows, over
    the HBM rate) and its device time by part: the causal kernels, the
    expert GEMMs (every ``aten::bmm`` is ``moe_ffn``'s), the rest of
    ``moe_ffn`` (router, top-k, ranks, dispatch, SwiGLU, combine) and
    everything else."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.kernels import backend
    from repro_torch.models import moe as MOE
    from repro_torch.tree import leaves
    t0 = time.perf_counter()
    eng, tracer, wall, n_warm = profiled_engine(torch, dev, cfg, params)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, _, dt, _, st = serve_lm(torch, backend, eng, True)
    rows, busy_us = report_profile(
        prof, dt, wall, tracer, n_warm, "moe continuous",
        f"depth 1, {PROFILE_LAYERS} of {cfg.num_layers} layers, 8 "
        f"requests x {LM_MAX_NEW} tokens, {st['pipeline_steps']} steps")
    causal = ("flash_decode_bf16", "flash_prefill_bf16")
    attn_us = sum(us for n, _, us in rows
                  if any(kernel_symbol(c) in n for c in causal))
    print(f"profile moe continuous: causal attention {attn_us / 1e3:.3f} ms "
          f"of {busy_us / 1e3:.3f} ms device busy ({attn_us / busy_us:.3f}); "
          f"{sum(r[1] for r in rows) / st['pipeline_steps']:.1f} device "
          f"launches per step over {st['runner_decode_calls']} decode and "
          f"{st['runner_prefill_slot_calls']} prefill calls; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    step = decode_step_alone(torch, dev, cfg, params)
    step_ms = time_ms(step, samples=5, calls=5, warmup=2)
    ffn, n = MOE.moe_ffn, 2

    def ranged(*a, **kw):
        with record_function("moe_ffn"):
            return ffn(*a, **kw)
    MOE.moe_ffn = ranged
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                step()
            torch.cuda.synchronize()
    finally:
        MOE.moe_ffn = ffn
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows) / n
    attn_us = sum(us for name, _, us in rows
                  if any(kernel_symbol(c) in name for c in causal)) / n
    # host entries' device time: that of the kernels they launched
    total = {e.key: e.device_time_total / n for e in prof.key_averages()
             if e.device_type == DeviceType.CPU}
    ffn_us, gemm_us = total.get("moe_ffn", 0.0), total.get("aten::bmm", 0.0)
    parts = {"causal attention kernels": attn_us,
             "expert GEMMs (aten::bmm)": gemm_us,
             "router, top-k, dispatch, SwiGLU and combine": ffn_us - gemm_us,
             "the rest": busy_us - attn_us - ffn_us}
    w_bytes = sum(t.numel() * t.element_size() for k, v in params.items()
                  if k != "embed" for t in leaves(v))
    floor_ms = w_bytes / PEAK_HBM_BYTES * 1e3
    print(f"moe: one decode step alone (B=4, 572-slot cache): wall "
          f"{step_ms:.3f} ms, {sum(r[1] for r in rows) / n:g} device "
          f"launches, device {busy_us / 1e3:.3f} ms against the "
          f"{floor_ms:.3f} ms floor ({w_bytes / 1e9:.3f} GB of weights over "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s; {busy_us / 1e3 / floor_ms:.2f}"
          f"x); by part: " + ", ".join(
              f"{k} {v / 1e3:.3f} ms ({v / busy_us:.3f})"
              for k, v in parts.items())
          + f"; {time.perf_counter() - t0:.1f} s", flush=True)


def moe_path(torch, dev):
    """Phase 4d. Full-width Granite-MoE-3B-A800M (``lm_serve_params``) serving
    the 8 requests on each of ``LM_SERVES`` (``run_lm_serves``); the
    call-for-call oracle on continuous depth 1 (and on static waves'
    tokens where they differ from those), with the real pairs
    dropped per prefill call; a no-drop variant (capacity factor E / K, so
    C >= T in every call) served once continuous at depth 1 and in static
    waves under the teacher-forced oracle; ``profile_moe``. Then Qwen2-MoE-A2.7B at full width
    and ``MOE_QWEN_LAYERS`` layers, continuous at depth 1, under the
    call-for-call oracle. No plain attention may run. Returns ({path:
    launch counts of its last timed depth-1 serve}, {serve: host syncs
    per serve})."""
    from repro_torch.configs import GRANITE_MOE_3B_A800M, QWEN2_MOE_A2_7B
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import attention as A
    t0 = time.perf_counter()
    counts, syncs = {}, {}
    cfg = GRANITE_MOE_3B_A800M
    with count_plain((FA, "attention_causal_plain"),
                     (A, "flash_attention_torch")) as plain:
        params = lm_serve_params(torch, dev, cfg, "moe")
        last, _, s = run_lm_serves(torch, dev, cfg, params, "moe",
                                   repeats=MOE_REPEATS)
        counts["moe"] = last["continuous depth 1"][2]
        syncs.update({f"moe {k}": v for k, v in s.items()})
        print(f"moe: serves done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        drops = check_moe_call_oracle(torch, cfg, params,
                                      last["continuous depth 1"][0], dev,
                                      "moe continuous depth 1")
        print("moe: real (token, expert) pairs dropped / routed per prefill "
              f"call, over {cfg.num_layers} layers (prompts "
              f"{[len(r.prompt) for r in last['continuous depth 1'][0]]}; "
              "the call's aux loss per layer after each): "
              + ", ".join(f"{int(d)}/{int(n)} ({a:.3f})"
                          for d, n, a in drops), flush=True)
        # static waves prefill slot by slot too (``per_slot_prefill``): the
        # same prefill calls, so the same drops; the same tokens then meet
        # the same oracle
        if last["static waves"][1] == last["continuous depth 1"][1]:
            print("moe static waves: tokens identical to continuous depth "
                  "1's (the same prefill calls and drops): the same "
                  "call-for-call oracle holds", flush=True)
        else:
            check_moe_call_oracle(torch, cfg, params,
                                  last["static waves"][0], dev,
                                  "moe static waves")
        print(f"moe: call-for-call oracle done at "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        nd = cfg.replace(moe_capacity_factor=cfg.moe_num_experts
                         / cfg.moe_top_k)
        nd_serves = tuple(x for x in LM_SERVES
                          if x[0] in ("continuous depth 1", "static waves"))
        last_nd, _, s = run_lm_serves(torch, dev, nd, params,
                                         "moe no-drop", nd_serves,
                                         repeats=1, warm=False)
        syncs.update({f"moe no-drop {k}": v for k, v in s.items()})
        for label, _, _ in nd_serves:
            check_lm_oracle(torch, nd, params, last_nd[label][0], dev,
                            f"moe no-drop {label}")
        print(f"moe: no-drop variant done at {time.perf_counter() - t0:.1f} "
              f"s", flush=True)
        profile_moe(torch, dev, cfg, params)
        print(f"moe: profile done at {time.perf_counter() - t0:.1f} s",
              flush=True)
        del params
        torch.cuda.empty_cache()
        qcfg = QWEN2_MOE_A2_7B.replace(num_layers=MOE_QWEN_LAYERS)
        print(f"moe qwen: {QWEN2_MOE_A2_7B.name} at full width, "
              f"{MOE_QWEN_LAYERS} of {QWEN2_MOE_A2_7B.num_layers} layers",
              flush=True)
        params = lm_serve_params(torch, dev, qcfg, "moe qwen")
        last, _, s = run_lm_serves(torch, dev, qcfg, params, "moe qwen",
                                      LM_SERVES[:1])
        counts["moe qwen"] = last["continuous depth 1"][2]
        syncs.update({f"moe qwen {k}": v for k, v in s.items()})
        drops = check_moe_call_oracle(torch, qcfg, params,
                                      last["continuous depth 1"][0], dev,
                                      "moe qwen continuous depth 1")
        print("moe qwen: real (token, expert) pairs dropped / routed per "
              f"prefill call, over {qcfg.num_layers} layers (aux loss per "
              "layer after each): "
              + ", ".join(f"{int(d)}/{int(n)} ({a:.3f})"
                          for d, n, a in drops), flush=True)
        del params
        torch.cuda.empty_cache()
    require(not any(plain.values()),
            f"moe: a plain attention ran on the card: {plain}")
    print(f"moe: phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    return counts, syncs


# ---------------------------------------------------------------------------
# Phase 3 (recurrent families): the scans against their plain versions
# ---------------------------------------------------------------------------
# (label, B, S): the recurrent serve's whole-batch prefill (4 slots, a
# 512-token row), its re-prefill length (500: a ragged last chunk) and its
# decode step; then the prefill with strong decays (down to exactly 0)
SCAN_FORMS = (("prefill", 4, 512), ("re-prefill", 4, 500), ("decode", 4, 1))
SCAN_STRONG = ("prefill, strong decays", 4, 512)
SCAN_SPLIT = 200  # S1 of the prefill split as S1 + (S - S1), state carried
# y and, in the chunked form, the final state against the plain version:
# fp32 sums of dh or N terms, and in the chunked form of a chunk's steps
# taken as products, in another order. The sequential form's state is
# bitwise (the plain loop's rounded products and sums in its order); the
# chunked form's is not, nor is a split prefill's continuation
SCAN_TOL = 1e-5   # x max(1, max|plain|)
SCAN_KERNELS = (  # kind, entry point, source, config whose widths it takes
    ("mamba", "mamba_scan_f32", "mamba_scan.cu", "ZAMBA2_1_2B"),
    ("wkv6", "wkv6_f32", "wkv6.cu", "RWKV6_1_6B"))


def scan_inputs(torch, dev, kind, cfg, B, S, g, strong=False):
    """A scan's inputs at ``cfg``'s full widths, drawn from ``g`` and
    shaped as the model makes them: Mamba2's dt through softplus, decay
    exp(-dt A) with A of 1..16 (``init_mamba_params``); RWKV6's w =
    exp(-exp(-6 + noise)) (``w_bias`` -6), near 1; bf16 activations,
    random incoming states. ``strong``: Mamba2's dt scaled by 10, so dt A
    passes 104 and decays reach exactly 0; RWKV6's w_raw uniform on [-6,
    5], so w runs from near 1 to exactly 0."""
    rand = lambda *s: torch.randn(s, generator=g)
    if kind == "mamba":
        inner = cfg.ssm_expand * cfg.d_model
        H, dh, N = inner // 64, 64, cfg.ssm_state
        dt = torch.nn.functional.softplus(rand(B, S, H)) * (
            10.0 if strong else 1.0)
        args = (rand(B, S, H, dh).to(torch.bfloat16), dt,
                torch.exp(-dt * torch.linspace(1.0, 16.0, H)), rand(B, S, N),
                rand(B, S, N), 0.1 * rand(B, H, dh, N))
    else:
        H, dh = cfg.num_heads, cfg.d_model // cfg.num_heads
        w_raw = (-6.0 + 11.0 * torch.rand((B, S, H, dh), generator=g)
                 if strong else -6.0 + rand(B, S, H, dh))
        args = (*(rand(B, S, H, dh).to(torch.bfloat16) for _ in range(3)),
                torch.exp(-torch.exp(w_raw)), 0.1 * rand(H, dh),
                0.1 * rand(B, H, dh, dh))
    return tuple(t.to(dev) for t in args)


def scan_bound(kind, args):
    """(bound ms, bound by) of one scan call: each input read once and y and
    the state written once (bytes); 5 fp32 operations per (d, n, t) for
    Mamba2 (two products and a sum for the state, a product and a sum for
    y), 7 per (d, e, t) for the WKV (k v, u k v, its sum with s, r times
    that summed, s w plus k v)."""
    n_bytes = sum(t.numel() * t.element_size() for t in args)
    B, S, H, dh = args[0].shape
    n_bytes += 4 * (B * S * H * dh + args[-1].numel())  # y, the new state
    if kind == "mamba":
        return bound_ms(n_bytes, 5 * B * S * H * dh * args[3].shape[-1])
    return bound_ms(n_bytes, 7 * B * S * H * dh * dh)


def check_ssm_scans(torch, dev):
    """``mamba_scan_f32`` at full-width Zamba2-1.2B and ``wkv6_f32`` at
    full-width RWKV6-1.6B, each at ``SCAN_FORMS`` and ``SCAN_STRONG``,
    against its plain version: y within ``SCAN_TOL``; the final state
    bitwise in the sequential form, within ``SCAN_TOL`` in the chunked
    form (each case prints the form that ran); two launches bitwise equal;
    from S > 1, S split as ``SCAN_SPLIT`` + the rest with the state carried
    against one pass (bitwise when every call runs sequential, else within
    the same bounds). No library call computes either scan. Returns one
    check per kernel, a case per form."""
    from repro_torch import configs
    from repro_torch.kernels import backend
    from repro_torch.kernels.ssm_scan import ops as SS
    g = torch.Generator().manual_seed(12)
    checks = []
    within = (lambda got, ref: ((got - ref).abs().max().item(),
                                SCAN_TOL * max(1.0, ref.abs().max().item())))
    tol_text = f"{SCAN_TOL:g} x max(1, max|plain|)"
    for kind, entry, source, cfg_name in SCAN_KERNELS:
        cfg = getattr(configs, cfg_name)
        fn, plain = ((SS.mamba_scan, SS.mamba_scan_plain) if kind == "mamba"
                     else (SS.wkv6, SS.wkv6_plain))
        cases = []
        for label, B, S in (*SCAN_FORMS, SCAN_STRONG):
            args = scan_inputs(torch, dev, kind, cfg, B, S, g,
                               strong=(label, B, S) == SCAN_STRONG)
            form = SS.scan_form(kind, S)
            label = f"{label}, {form} form"
            before = backend.launches()[entry]
            (y, s), again = fn(*args), fn(*args)
            y_ref, s_ref = plain(*args)
            torch.cuda.synchronize()
            tag = f"{entry} ({label})"
            require(backend.launches()[entry] == before + 2,
                    f"{tag}: not one launch a call")
            require(bool(torch.isfinite(y).all() and torch.isfinite(s).all()),
                    f"{tag}: not finite")
            require(torch.equal(y, again[0]) and torch.equal(s, again[1]),
                    f"{tag}: two launches differ")
            errs = [(f"y ({label})", *within(y, y_ref), tol_text),
                    (f"state ({label})", *within(s, s_ref), tol_text)
                    if form == "chunked" else
                    (f"state ({label})", (s - s_ref).abs().max().item(), 0.0,
                     "bitwise")]
            if S > 1:
                seq = lambda a, b: tuple(t[:, a:b].contiguous()
                                         if t.shape[:2] == (B, S) else t
                                         for t in args[:-1])
                ya, sa = fn(*seq(0, SCAN_SPLIT), args[-1])
                yb, sb = fn(*seq(SCAN_SPLIT, S), sa)
                yc = torch.cat([ya, yb], 1)
                if {SS.scan_form(kind, n) for n in (S, SCAN_SPLIT,
                                                    S - SCAN_SPLIT)} == \
                        {"sequential"}:
                    split = max((yc - y).abs().max().item(),
                                (sb - s).abs().max().item())
                    errs.append((f"split at {SCAN_SPLIT} ({label})", split,
                                 0.0, "bitwise one pass"))
                else:
                    errs += [(f"split at {SCAN_SPLIT}, y ({label})",
                              *within(yc, y), f"{tol_text} of one pass"),
                             (f"split at {SCAN_SPLIT}, state ({label})",
                              *within(sb, s), f"{tol_text} of one pass")]
            bnd, by = scan_bound(kind, args)
            shapes = (f"{' '.join(f'{list(t.shape)}' for t in args)} "
                      f"({cfg.name} widths, {label}; activations bf16)")
            call = lambda a=args, f=fn: f(*a)
            cases.append(dict(
                label=label, errs=errs, fn=call, ms=time_ms(call),
                plain_ms=time_ms(lambda a=args, f=plain: f(*a), samples=3,
                                 calls=1, warmup=1),
                library_fn=None, library_ms=None, bound_ms=bnd, bound_by=by,
                shapes=shapes))
        head = cases[0]
        checks.append(dict(
            name=entry, source=source,
            errs=[e for c in cases for e in c["errs"]], fn=head["fn"],
            ms=head["ms"], plain_ms=head["plain_ms"], library_fn=None,
            library_ms=None, library_call=None, bound_ms=head["bound_ms"],
            bound_by=head["bound_by"],
            shapes="; ".join(c["shapes"] for c in cases), cases=cases))
    return checks


# ---------------------------------------------------------------------------
# Phase 3 (recurrent training): the scans' backward against their plain
# versions
# ---------------------------------------------------------------------------
# (label, B, S, activations, regime, nonzero states): the training step's
# scan (8 x 512, bf16, zero initial state and no final-state gradient: the
# headline, timed; the chunked form), then the edges: fp32 activations, S =
# 1, each side of the chunked form's first length (``BWD_CHUNK_MIN``, 32:
# 31 sequential, 32 chunked), S 33 and 70 (a chunk and a part), strong
# decays (down to exactly 0), decays exactly 1, nonzero h0 / s0 and
# final-state gradients
SCAN_BWD_CASES = (("training step", 8, 512, "bf16", "model", False),
                  ("fp32, S 200", 2, 200, "fp32", "model", True),
                  ("S 1", 2, 1, "bf16", "model", True),
                  ("S 33", 2, 33, "bf16", "model", True),
                  ("S 70, strong decays", 2, 70, "fp32", "strong", True),
                  ("S 31", 2, 31, "bf16", "model", True),
                  ("S 32", 2, 32, "bf16", "model", True),
                  ("S 100, decays 1", 2, 100, "fp32", "one", True))
# each gradient against the plain backward's (both fp32): sums over 64 rows
# or columns and over the steps in another order, fused multiply-adds where
# the plain version rounds twice, and in the chunked form the chunk's sums
# as 3xTF32 products (about 2^-21 a product; measured on an NVIDIA H100
# 80GB HBM3 at 700 W, tools/scan_bwd_probe.py: the sequential form at most
# 1.1e-6 x max|plain| at every case)
SCAN_BWD_TOL = 1e-5  # x max(1, max|plain|)
SCAN_BWD_KERNELS = (  # kind, entry point, source, config whose widths it takes
    ("mamba", "mamba_scan_bwd_f32", "mamba_scan_bwd.cu", "ZAMBA2_1_2B"),
    ("wkv6", "wkv6_bwd_f32", "wkv6_bwd.cu", "RWKV6_1_6B"))
SCAN_BWD_OUTS = {"mamba": ("dx", "ddt", "ddecay", "dB", "dC", "dh0"),
                 "wkv6": ("dr", "dk", "dv", "dw", "du", "ds0")}


def scan_bwd_bound(kind, args, grads):
    """(bound ms, bound by) of one backward call: each input and incoming
    gradient read once, each gradient written once (bytes); 14 fp32
    operations per state element and step (recomputing the state once, 3;
    the adjoint, 3; its four sums, 8; ``csrc/*_bwd.cu``)."""
    n_bytes = sum(t.numel() * t.element_size() for t in (*args, *grads))
    n_bytes += 4 * sum(t.numel() for t in args)
    B, S, H, dh = args[0].shape
    width = args[3].shape[-1] if kind == "mamba" else dh
    return bound_ms(n_bytes, 14 * B * S * H * dh * width)


def check_scan_training(torch, dev):
    """``mamba_scan_bwd_f32`` at full-width Zamba2-1.2B and
    ``wkv6_bwd_f32`` at full-width RWKV6-1.6B, each at
    ``SCAN_BWD_CASES``, against ``mamba_scan_bwd_plain`` /
    ``wkv6_bwd_plain`` on the same inputs and incoming gradients: each
    gradient within ``SCAN_BWD_TOL``; two launches bitwise equal; one
    launch a call (each case prints the form that ran). No library call
    computes either gradient. Returns one check per kernel, a case per
    shape."""
    from repro_torch import configs
    from repro_torch.kernels import backend
    from repro_torch.kernels.ssm_scan import ops as SS
    g = torch.Generator().manual_seed(14)
    checks = []
    tol_text = f"{SCAN_BWD_TOL:g} x max(1, max|plain|)"
    for kind, entry, source, cfg_name in SCAN_BWD_KERNELS:
        cfg = getattr(configs, cfg_name)
        fn, plain = ((SS._mamba_scan_bwd_cuda, SS.mamba_scan_bwd_plain)
                     if kind == "mamba" else
                     (SS._wkv6_bwd_cuda, SS.wkv6_bwd_plain))
        cases = []
        for label, B, S, act, regime, nonzero in SCAN_BWD_CASES:
            args = scan_inputs(torch, dev, kind, cfg, B, S, g,
                               strong=regime == "strong")
            if regime == "one":  # Mamba2's decay, the WKV's w
                at = 2 if kind == "mamba" else 3
                args = (*args[:at], torch.ones_like(args[at]),
                        *args[at + 1:])
            form = SS.bwd_form(kind, S)
            label = f"{label}, {form} form"
            if act == "fp32":
                args = tuple(t.float() for t in args)
            if not nonzero:
                args = (*args[:-1], torch.zeros_like(args[-1]))
            y_shape = args[0].shape
            dy = torch.randn(y_shape, generator=g).to(dev)
            ds = (0.1 * torch.randn(args[-1].shape, generator=g).to(dev)
                  if nonzero else torch.zeros_like(args[-1]))
            grads = (dy, ds)
            before = backend.launches()[entry]
            got, again = fn(*args, *grads), fn(*args, *grads)
            ref = plain(*args, *grads)
            torch.cuda.synchronize()
            tag = f"{entry} ({label})"
            require(backend.launches()[entry] == before + 2,
                    f"{tag}: not one launch a call")
            require(all(bool(torch.isfinite(t).all()) for t in got),
                    f"{tag}: not finite")
            require(all(torch.equal(a, b) for a, b in zip(got, again)),
                    f"{tag}: two launches differ")
            errs = []
            for name, a, r in zip(SCAN_BWD_OUTS[kind], got, ref):
                errs.append((f"{name} ({label})",
                             (a - r).abs().max().item(),
                             SCAN_BWD_TOL * max(1.0, r.abs().max().item()),
                             tol_text))
            bnd, by = scan_bwd_bound(kind, args, grads)
            shapes = (f"{' '.join(f'{list(t.shape)}' for t in args)} "
                      f"({cfg.name} widths, {label}; activations {act}, "
                      f"{'nonzero' if nonzero else 'zero'} initial state "
                      f"and final-state gradient)")
            call = lambda a=args, d=grads, f=fn: f(*a, *d)
            headline = not cases
            cases.append(dict(
                label=label, errs=errs, fn=call,
                kernels_per_launch=KERNELS_PER_LAUNCH[entry]
                if form == "chunked" else 2,
                ms=time_ms(call, samples=11 if headline else 5,
                           calls=5 if headline else 3, warmup=2),
                plain_ms=time_ms(lambda a=args, d=grads, f=plain: f(*a, *d),
                                 samples=1, calls=1, warmup=0),
                library_fn=None, library_ms=None, bound_ms=bnd, bound_by=by,
                shapes=shapes))
            del got, again, ref
        head = cases[0]
        checks.append(dict(
            name=entry, source=source,
            errs=[e for c in cases for e in c["errs"]], fn=head["fn"],
            ms=head["ms"], plain_ms=head["plain_ms"], library_fn=None,
            library_ms=None, library_call=None, bound_ms=head["bound_ms"],
            bound_by=head["bound_by"],
            shapes="; ".join(c["shapes"] for c in cases), cases=cases))
    torch.cuda.empty_cache()
    return checks


# ---------------------------------------------------------------------------
# Phase 4e, the SSM and hybrid families: full-width Zamba2-1.2B and
# RWKV6-1.6B through ServeEngine
# ---------------------------------------------------------------------------
SSM_REPEATS = 1  # timed serves of each path after its warm-up
# Zamba2-1.2B with random weights is chaotic in bf16 at depth: a random
# half of the embedding moved by one bf16 ulp moves its logits by up to
# 1.82 at 38 layers (argmaxes equal at 6% of positions) and 0.21 at 6
# (``tools/ssm_probe.py``, NVIDIA H100 80GB HBM3, 700 W), and the
# reference does the same on the CPU. A wrong state or cache would leave
# the engine's tokens near random at any depth, and that shows against
# the witness only where the witness stays small. So the oracle gates a
# full-width Zamba2 cut to one stage (6 Mamba2 layers and the shared
# block) and a tail layer, and is printed ungated at full depth.
ZAMBA2_ORACLE_LAYERS = 7
ZAMBA2_CHAOS = ("at 38 layers the random-init Zamba2's own bf16 noise "
                "swamps any tolerance; the gate runs at 7 layers")
SSM_SERVES = {"zamba2-1.2b": LM_SERVES,       # d1, d2, KV prune, static
              "rwkv6-1.6b": LM_SERVES[:2]}    # d1, d2


@contextlib.contextmanager
def record_prefill_rows():
    """While the block runs, record for every engine's whole-batch prefill
    each running request's row (left padding included: recurrent state
    absorbs pad tokens) and how many tokens it had generated before it.
    Yields {id(engine): {uid: (row, n generated)}}, the last prefill of
    each request kept."""
    import numpy as np
    from repro_torch.serving import ServeEngine
    from repro_torch.serving.runner import build_padded_batch
    rows, inner = {}, ServeEngine._prefill_prefixes

    def recorded(self, prefixes, max_new):
        toks, _ = build_padded_batch(prefixes)
        mine = rows.setdefault(id(self), {})
        for slot, req in self.scheduler.running.items():
            mine[req.uid] = (np.array(toks[slot]), len(req.generated))
        return inner(self, prefixes, max_new)
    ServeEngine._prefill_prefixes = recorded
    try:
        yield rows
    finally:
        ServeEngine._prefill_prefixes = inner


def check_recurrent_oracle(torch, cfg, params, reqs, rows, dev, label,
                           gate=True):
    """The call-for-call oracle of a recurrent serve: for each request, one
    ``forward_lm`` (train mode, no state, B=1) over its row as last
    prefilled (pad tokens and all) plus the tokens decoded after it; one
    pass over the whole sequence stands against the engine's prefill state
    carried through its decode steps. The same forward with a random half
    of the embedding moved by one bf16 ulp is the witness: how far the
    model alone moves its own argmax token (the gap at that token, as
    ``token_gaps`` measures the engine's). With ``gate``, each engine
    token's logit lies within ``LM_ORACLE_TOL`` of its position's largest,
    or within the witness's largest gap where the model's own bf16 noise
    is larger; else both are printed only."""
    import numpy as np
    from repro_torch.models import model as M
    emb = params["embed"]
    up = torch.nextafter(emb, torch.full_like(emb, float("inf")))
    half = torch.rand(emb.shape, generator=torch.Generator(
        emb.device).manual_seed(2), device=emb.device) < 0.5
    moved = dict(params, embed=torch.where(half, up, emb))
    worst, exact, n, wit, wit_exact = 0.0, 0, 0, 0.0, 0
    for r in reqs:
        row, g = rows[r.uid]
        seq = torch.from_numpy(np.concatenate(
            [row, r.generated[g:-1]]).astype(np.int64))[None].to(dev)
        with torch.no_grad():
            logits, shifted = (M.forward_lm(cfg, p, seq).logits[
                0, len(row) - 1:] for p in (params, moved))
        w, e = token_gaps(torch, logits, r.generated[g:], dev)
        ww, we = token_gaps(torch, shifted, logits.argmax(dim=1).tolist(),
                            dev)
        worst, exact, n = max(worst, w), exact + e, n + len(r.generated) - g
        wit, wit_exact = max(wit, ww), wit_exact + we
    del moved, up, half
    tol = max(LM_ORACLE_TOL, wit)
    require(not gate or worst <= tol,
            f"{label}: an engine token's oracle logit lies {worst:.4g} below "
            f"its position's largest (tolerance {tol:.4g}: {LM_ORACLE_TOL} "
            f"or the witness's {wit:.4g})")
    print(f"{label}: call-for-call oracle over each row as last prefilled: "
          f"{exact}/{n} tokens the exact argmax ({exact / n:.3f}), largest "
          f"gap {worst:.4g}; witness (one bf16 ulp on half the embedding) "
          f"keeps {wit_exact}/{n} argmaxes, largest gap {wit:.4g}; "
          + (f"tolerance {tol:.4g}" if gate else
             f"measured, not gated: {ZAMBA2_CHAOS}"), flush=True)


@contextlib.contextmanager
def record_first_prune():
    """While the block runs, keep what the first KV prune took in and gave
    back (no wait on the card inside the serve); ``check_first_prune``
    reads it after. Yields {"pairs": [(in, out)], "keep_frac"} or {}."""
    from repro_torch.serving import cache_manager as CM
    seen, inner = {}, CM.prune_kv_caches

    def recorded(caches, keep_frac, starts=None):
        pruned, new_starts = inner(caches, keep_frac, starts=starts)
        if not seen:
            seen.update(pairs=list(zip(caches, pruned)), keep_frac=keep_frac)
        return pruned, new_starts
    CM.prune_kv_caches = recorded
    try:
        yield seen
    finally:
        CM.prune_kv_caches = inner


def check_first_prune(torch, seen, tag):
    """Gate (c) of the KV-pruned hybrid serve: at the first prune, every
    ``KVCache`` (the shared blocks') came back compacted to the keep count
    and every Mamba2 state came back as it went in, the same tensors and
    so bitwise what an unpruned step carries on."""
    from repro_torch.models import attention as A
    from repro_torch.serving import cache_manager as CM
    require(bool(seen), f"{tag}: the pruned serve never pruned")
    kv = [(a, b) for a, b in seen["pairs"] if isinstance(a, A.KVCache)]
    states = [(a, b) for a, b in seen["pairs"]
              if not isinstance(a, A.KVCache)]
    keep = CM._keep_count(kv[0][0].k.shape[1], seen["keep_frac"])
    require(all(bool((b.length == keep).all()) for _, b in kv),
            f"{tag}: a shared block's cache was not compacted to the keep "
            f"count at the first prune")
    require(all(x is y and torch.equal(x, y)
                for a, b in states for x, y in zip(a, b)),
            f"{tag}: a Mamba2 state changed at the first prune")
    print(f"{tag} continuous kv-prune: at the first prune {len(kv)} "
          f"shared-block caches compacted to {keep} slots, {len(states)} "
          f"Mamba2 states passed on as they were (the same tensors)",
          flush=True)


def recurrent_decode_step(torch, dev, cfg, params):
    """One batch-4 decode step of the engine's runner, as a closure: zeroed
    recurrent states, and the shared blocks' 572-slot caches at the decode
    check's lengths."""
    from repro_torch.models import attention as A
    from repro_torch.models import steps as ST
    eng = lm_engine(cfg, params, dev)
    lens = torch.tensor(LM_DECODE[4], dtype=torch.int32, device=dev) - 1
    caches = [c._replace(length=lens.clone()) if isinstance(c, A.KVCache)
              else c for c in ST.init_caches(cfg, LM_MAX_BATCH, LM_MAX_LEN,
                                             device=dev)]
    toks = torch.zeros((LM_MAX_BATCH,), dtype=torch.int64, device=dev)
    return lambda: eng.runner.decode(toks, caches, None)


def _device_parts(rows, n, scan):
    """A profiled window's device µs a call by part: the scan kernel, the
    causal kernels, GEMMs, the rest."""
    groups = {"scan kernel": lambda nm: kernel_symbol(scan) in nm,
              "causal kernels": lambda nm: any(
                  kernel_symbol(c) in nm
                  for c in ("flash_decode_bf16", "flash_prefill_bf16")),
              "GEMMs": lambda nm: "nvjet" in nm or "gemm" in nm.lower()
              or "xmma" in nm}
    parts = {k: 0.0 for k in [*groups, "the rest"]}
    for nm, _, us in rows:
        parts[next((k for k, f in groups.items() if f(nm)),
                   "the rest")] += us / n
    return parts


def profile_recurrent(torch, dev, cfg, params, tag, scan):
    """One batch-4 decode step alone: its wall (CUDA events around
    back-to-back steps, so a host-bound step is timed at its issue rate)
    and, from 5 steps profiled on the card's side (kernel records only:
    the parts go by kernel name), its device launches, its idle share
    (1 - device time / wall), and its device time against the least the
    card could take (the bytes of every weight it reads, all but the
    embedding table, plus the recurrent states read and written, over the
    HBM rate) and by part: the scan kernel, the causal kernels, GEMMs,
    the rest. Then ``profile_reprefill``. (A whole serve is not profiled
    here: parsing its ~150,000 kernel records costs tens of seconds a
    model.)"""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import attention as A
    from repro_torch.models import steps as ST
    from repro_torch.tree import leaves
    step = recurrent_decode_step(torch, dev, cfg, params)
    step_ms = time_ms(step, samples=5, calls=5, warmup=2)
    n = 5
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows) / n
    parts = _device_parts(rows, n, scan)
    states = [c for c in ST.init_caches(cfg, LM_MAX_BATCH, 1, device=dev)
              if not isinstance(c, A.KVCache)]
    s_bytes = 2 * sum(t.numel() * t.element_size() for c in states
                      for t in c)
    w_bytes = sum(t.numel() * t.element_size() for k, v in params.items()
                  if k != "embed" for t in leaves(v))
    floor_ms = (w_bytes + s_bytes) / PEAK_HBM_BYTES * 1e3
    print(f"{tag}: one decode step alone (B=4, 572-slot caches): wall "
          f"{step_ms:.3f} ms, {sum(r[1] for r in rows) / n:g} device "
          f"launches, idle share {1.0 - busy_us / 1e3 / step_ms:.3f}, "
          f"device {busy_us / 1e3:.3f} ms against the "
          f"{floor_ms:.3f} ms floor ({w_bytes / 1e9:.3f} GB of weights and "
          f"{s_bytes / 2 ** 20:.1f} MiB of states read and written over "
          f"{PEAK_HBM_BYTES / 1e12:.2f} TB/s; {busy_us / 1e3 / floor_ms:.2f}"
          f"x); by part: " + ", ".join(
              f"{k} {v / 1e3:.3f} ms ({v / busy_us:.3f})"
              for k, v in parts.items()), flush=True)
    profile_reprefill(torch, dev, cfg, params, tag, scan)


REPREFILL = (4, 500)  # the serve's whole-batch re-prefill: B x S


def profile_reprefill(torch, dev, cfg, params, tag, scan):
    """One whole-batch re-prefill alone (``REPREFILL``: the engine's
    runner from fresh caches, random tokens from a seed, no padding): its
    wall (CUDA events), and from 3 prefills profiled on the card's side
    its device launches and device time by part (the scan kernel, the
    causal kernels, GEMMs, the rest) with the scan's share: what the
    scans cost an admission of the recurrent families. Returns those
    numbers (``tools/scan_ab.py`` compares them across checkouts)."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import steps as ST
    eng = lm_engine(cfg, params, dev)
    B, S = REPREFILL
    tokens = np.random.default_rng(5).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)
    starts = np.zeros((B,), np.int32)
    caches = ST.init_caches(cfg, LM_MAX_BATCH, LM_MAX_LEN, device=dev)
    step = lambda: eng.runner.prefill(tokens, starts, caches)
    wall_ms = time_ms(step, samples=3, calls=2, warmup=1)
    n = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows) / n
    parts = _device_parts(rows, n, scan)
    launches = sum(r[1] for r in rows) / n
    print(f"{tag}: one whole-batch re-prefill alone (B={B}, S={S}, fresh "
          f"caches): wall {wall_ms:.3f} ms, {launches:g} device launches, "
          f"device {busy_us / 1e3:.3f} ms; by part: " + ", ".join(
              f"{k} {v / 1e3:.3f} ms ({v / busy_us:.3f})"
              for k, v in parts.items()), flush=True)
    return dict(wall_ms=wall_ms, launches=launches,
                device_ms=busy_us / 1e3,
                parts_ms={k: v / 1e3 for k, v in parts.items()})


def ssm_path(torch, dev):
    """Phase 4e. Full-width Zamba2-1.2B (38 Mamba2 layers and a shared
    attention block every 6; ``lm_serve_params``) serving the 8 requests
    continuous at depths 1 and 2, with KV pruning (keep 0.5 every 4 steps)
    and in static waves; full-width RWKV6-1.6B (24 layers) continuous at
    depths 1 and 2 (``run_lm_serves`` with their gates: the scan kernel
    once per recurrent layer of every call, the causal pair once per
    shared block of every call). Gates: (a) ``mamba_scan_f32`` (Zamba2),
    ``wkv6_f32`` (RWKV6) and the causal pair (Zamba2) launched, no plain
    scan or attention on the card; (b) the call-for-call oracle
    (``check_recurrent_oracle``) on continuous depth 1 and on static
    waves where their tokens differ: gated for RWKV6, printed for
    Zamba2 at 38 layers and gated on a continuous depth-1 serve of
    Zamba2 cut to ``ZAMBA2_ORACLE_LAYERS``; (c) at the first prune of the
    pruned Zamba2 serve, only the shared blocks' caches compacted, every
    Mamba2 state passed on as it was (``check_first_prune``). Prints
    tokens/s, the peak memory and ``profile_recurrent`` (one decode step
    by part). Returns ({path: launch counts of its last timed depth-1
    serve}, {serve: host syncs per serve})."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.models import attention as A
    t0 = time.perf_counter()
    counts, syncs = {}, {}
    with count_plain((SS, "mamba_scan_plain"), (SS, "wkv6_plain"),
                     (FA, "attention_causal_plain"),
                     (A, "flash_attention_torch")) as plain, \
            record_prefill_rows() as rows:
        for cfg, scan, tag in (
                (configs.ZAMBA2_1_2B, "mamba_scan_f32", "zamba2"),
                (configs.RWKV6_1_6B, "wkv6_f32", "rwkv6")):
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            params = lm_serve_params(torch, dev, cfg, tag)
            attn = (cfg.num_layers // cfg.attn_layer_period
                    if cfg.family == "hybrid" else 0)
            with record_first_prune() as pruned:
                last, _, s = run_lm_serves(
                    torch, dev, cfg, params, tag, SSM_SERVES[cfg.name],
                    repeats=SSM_REPEATS, attn_layers=attn,
                    scan=(scan, cfg.num_layers))
            syncs.update({f"{tag} {k}": v for k, v in s.items()})
            counts[tag] = last["continuous depth 1"][2]
            for key in ((scan, "flash_decode_bf16", "flash_prefill_bf16")
                        if attn else (scan,)):
                require(counts[tag][key] > 0,
                        f"{tag}: {key} never launched on the serve path")
            if "continuous kv-prune" in last:
                check_first_prune(torch, pruned, tag)
            del pruned
            gate = cfg.family != "hybrid"
            for label in ("continuous depth 1", "static waves"):
                if label not in last:
                    continue
                if label != "continuous depth 1" and last[label][1] == \
                        last["continuous depth 1"][1]:
                    print(f"{tag} {label}: tokens identical to continuous "
                          f"depth 1's (the same whole-batch prefills): the "
                          f"same oracle holds", flush=True)
                    continue
                reqs, eng = last[label][0], last[label][5]
                check_recurrent_oracle(torch, cfg, params, reqs,
                                       rows[id(eng)], dev, f"{tag} {label}",
                                       gate=gate)
            profile_recurrent(torch, dev, cfg, params, tag, scan)
            if not gate:
                # the gate at a depth where the random-init model's bf16
                # noise leaves the 0.05 tolerance meaningful
                del params, last
                torch.cuda.empty_cache()
                cut = cfg.replace(num_layers=ZAMBA2_ORACLE_LAYERS)
                params = lm_serve_params(torch, dev, cut, f"{tag} cut")
                last, _, s = run_lm_serves(
                    torch, dev, cut, params, f"{tag} cut", LM_SERVES[:1],
                    repeats=1, warm=False,
                    attn_layers=cut.num_layers // cut.attn_layer_period,
                    scan=(scan, cut.num_layers))
                syncs.update({f"{tag} cut {k}": v for k, v in s.items()})
                reqs, eng = last["continuous depth 1"][0], \
                    last["continuous depth 1"][5]
                check_recurrent_oracle(torch, cut, params, reqs,
                                       rows[id(eng)], dev,
                                       f"{tag} cut continuous depth 1")
            peak = torch.cuda.max_memory_allocated(dev) - base
            print(f"{tag}: peak {peak / 2 ** 30:.2f} GiB above the "
                  f"{base / 2 ** 30:.2f} GiB earlier phases hold; done at "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            del params, last
            torch.cuda.empty_cache()
    require(not any(plain.values()),
            f"ssm: a plain scan or attention ran on the card: {plain}")
    print(f"ssm: phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    return counts, syncs


# ---------------------------------------------------------------------------
# Phase 4f, VLM and audio: full-width Whisper-base and Llama-3.2-Vision-90B
# through make_prefill / make_decode_step
# ---------------------------------------------------------------------------
# (prompt lengths, left-padded to the longest; tokens generated per request)
MM_WHISPER = ((4, 9, 16, 32), 64)
MM_VISION = ((16, 32, 48, 64), 32)
MM_VISION_STAGES = 2  # of Llama-3.2-Vision-90B's 20 (5 layers each), if
#                       the fp32 draw and its bf16 copy fit; else 1
MM_GATE = 1.0  # every cross layer's gate (the reference initializes it to 0,
#                and tanh(0) = 0 would keep the cross-attention off the
#                logits)
MM_MARGIN_GIB = 6.0  # device memory kept free beside the VLM's weights


def vlm_param_bytes(cfg, n_stages: int) -> int:
    """fp32 bytes of the VLM's params at ``n_stages`` stages: each stage
    ``cross_attn_period - 1`` self-attention layers and a gated cross layer
    (attention and SwiGLU MLP each), plus embedding and unembedding."""
    D, F = cfg.d_model, cfg.d_ff
    attn = 2 * D * cfg.num_heads * cfg.head_dim \
        + 2 * D * cfg.num_kv_heads * cfg.head_dim
    layer = attn + 3 * D * F + 2 * D
    return 4 * (n_stages * cfg.cross_attn_period * layer
                + 2 * cfg.vocab_size * D + D)


def mm_batch(torch, dev, cfg, prompts, seed):
    """The serve's inputs: prompts of ``prompts`` tokens from ``seed``,
    left-padded to the longest (tokens [B, Lp] and ``valid_start`` [B] on
    the card), and the family's modality input drawn on the card from the
    same seed (vision embeddings [B, 1601, 8192] or audio frames [B, 1500,
    512], fp32)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    B, Lp = len(prompts), max(prompts)
    toks = np.zeros((B, Lp), np.int64)
    rows = [rng.integers(0, cfg.vocab_size, n) for n in prompts]
    for b, r in enumerate(rows):
        toks[b, Lp - len(r):] = r
    start = np.array([Lp - n for n in prompts], np.int32)
    n = (cfg.num_vision_tokens if cfg.family == "vlm"
         else cfg.num_audio_frames)
    x = torch.randn((B, n, cfg.vision_d_model or cfg.d_model),
                    generator=torch.Generator(dev).manual_seed(seed),
                    device=dev)
    return rows, torch.from_numpy(toks).to(dev), \
        torch.from_numpy(start).to(dev), x


def mm_serve(torch, cfg, params, toks, start, x, max_new):
    """Greedy generation of ``max_new`` tokens a row through the reference's
    serve steps: ``make_prefill`` over the left-padded prompts with the
    modality input, then ``make_decode_step`` per token (the VLM's vision
    embeddings at every step; the audio family's encoder output carried in
    prefill's cache pair). Tokens stay on the card, step to step. Returns
    [B, max_new] on the card."""
    from repro_torch.models import steps as ST
    B, Lp = toks.shape
    name = "vision_embeds" if cfg.family == "vlm" else "audio_frames"
    decode = ST.make_decode_step(cfg)
    with torch.no_grad():
        tok, caches = ST.make_prefill(cfg)(
            params, {"tokens": toks, "valid_start": start, name: x},
            ST.init_caches(cfg, B, Lp + max_new, device=toks.device))
        out = [tok]
        for _ in range(max_new - 1):
            tok, caches = decode(params, out[-1][:, None], caches,
                                 vision_embeds=x if cfg.family == "vlm"
                                 else None, valid_start=start)
            out.append(tok)
    return torch.stack(out, dim=1)


def check_mm_oracle(torch, cfg, params, rows, x, gen, dev, tag):
    """The teacher-forced oracle of ``check_lm_oracle`` with the row's
    modality input: per request, ``forward_lm`` in train mode (no cache,
    B=1) over its prompt plus the generated tokens with its own vision
    embeddings or audio frames; each generated token's logit within
    ``LM_ORACLE_TOL`` of its position's largest."""
    from repro_torch.models import model as M
    name = "vision_embeds" if cfg.family == "vlm" else "audio_frames"
    worst, exact, n = 0.0, 0, 0
    for b, prompt in enumerate(rows):
        g = gen[b].tolist()
        seq = torch.tensor([*prompt.tolist(), *g[:-1]], device=dev)
        with torch.no_grad():
            logits = M.forward_lm(cfg, params, seq[None], **{
                name: x[b:b + 1]}).logits[0, len(prompt) - 1:]
        w, e = token_gaps(torch, logits, g, dev)
        worst, exact, n = max(worst, w), exact + e, n + len(g)
    require(worst <= LM_ORACLE_TOL,
            f"{tag}: a generated token's oracle logit lies {worst:.4g} below "
            f"its position's largest (tolerance {LM_ORACLE_TOL})")
    print(f"{tag}: teacher-forced oracle: {exact}/{n} tokens the exact "
          f"argmax ({exact / n:.3f}), largest gap {worst:.4g} (tolerance "
          f"{LM_ORACLE_TOL})", flush=True)


def mm_launches(cfg, max_new):
    """The launches one serve must make, by entry point and form: the
    decoder's causal self-attention once per self-attention layer of the
    prefill and of every decode step, and the non-causal kernels once per
    cross layer of each (and per encoder layer at Whisper's prefill)."""
    from repro_torch.models import model as M
    if cfg.family == "vlm":
        n_stages, n_self = M.vlm_layout(cfg)
        n_causal, n_cross, n_enc = n_stages * n_self, n_stages, 0
    else:
        n_causal = n_cross = cfg.num_layers
        n_enc = cfg.encoder_layers
    steps = max_new - 1
    return {"flash_prefill_bf16": n_causal + n_cross + n_enc,
            "flash_decode_bf16": (n_causal + n_cross) * steps,
            "flash_prefill_bf16/noncausal": n_cross + n_enc,
            "flash_decode_bf16/noncausal": n_cross * steps}


def mm_model(torch, dev, cfg, tag, prompts, max_new, seed):
    """Serve ``cfg`` once as a warm-up, once timed (launch counts set to 0
    just before and read just after, host waits counted) and once under
    the profiler; gate the launches (``mm_launches``, nothing else
    launched) and the tokens (``check_mm_oracle``). Prints tokens/s,
    launches per serve and the profiled serve's busy and idle share.
    Returns the timed serve's launch counts, entry points and forms
    together."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    params = lm_serve_params(torch, dev, cfg, tag)
    if cfg.family == "vlm":
        for c in params["stages"]["cross"]:
            c["gate"].fill_(MM_GATE)
        print(f"{tag}: every cross layer's gate set to {MM_GATE} "
              f"(tanh {math.tanh(MM_GATE):.4f})", flush=True)
    rows, toks, start, x = mm_batch(torch, dev, cfg, prompts, seed)
    B = len(prompts)

    def serve():
        return mm_serve(torch, cfg, params, toks, start, x, max_new)
    serve()
    gen, dt, counts, syncs = timed_window(torch, backend, serve)
    forms = backend.form_launches()
    counts.update(forms)
    want = mm_launches(cfg, max_new)
    got = {k: v for k, v in counts.items() if v}
    require(got == want, f"{tag}: one serve launched {got}, not {want}")
    gen = gen.cpu()
    require(gen.shape == (B, max_new) and bool(
        ((gen >= 0) & (gen < cfg.vocab_size)).all()),
        f"{tag}: generated tokens {tuple(gen.shape)} out of the vocabulary")
    check_mm_oracle(torch, cfg, params, rows, x, gen, dev, tag)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        dt_prof = time.perf_counter() - t0
    rows_dev = _device_rows(prof)
    busy = sum(r[2] for r in rows_dev)
    part = {}
    for name, k, us in rows_dev:
        key = next((e for e in (*backend.FORMS, "flash_prefill_bf16",
                                "flash_decode_bf16")
                    if kernel_symbol(e) in name), "other")
        part[key] = part.get(key, 0.0) + us
    print(f"{tag}: {B} requests (prompts {list(prompts)} left-padded to "
          f"{max(prompts)}) x {max_new} tokens in {dt:.4f} s: "
          f"{B * max_new / dt:.2f} tokens/s, {dt / max_new * 1e3:.3f} ms "
          f"per step; launches per serve {json.dumps(got)} "
          f"({sum(backend.launches().values())} kernel launches); host "
          f"syncs in the serve {syncs}; profiled serve: wall "
          f"{dt_prof * 1e6:.0f} us, device busy {busy:.0f} us, idle share "
          f"{1 - busy / (dt_prof * 1e6):.3f} profiled / "
          f"{1 - busy / (dt * 1e6):.3f} unprofiled; device us by part "
          + json.dumps({k: round(v, 1) for k, v in part.items()}),
          flush=True)
    del params
    torch.cuda.empty_cache()
    return counts


def multimodal_path(torch, dev):
    """Phase 4f. Full-width Whisper-base (6 encoder and 6 decoder layers, D
    512, 8 heads of Dh 64, d_ff 2048, vocab 51,865, biases) serving 4
    requests with their own 1500 audio frames (prompts of 4, 9, 16 and 32
    tokens left-padded to 32, 64 tokens generated each), and
    Llama-3.2-Vision-90B at full width (D 8192, 64 query over 8 KV heads
    of Dh 128, d_ff 28,672, vocab 128,256, 1601 vision tokens) and cut
    depth (``MM_VISION_STAGES`` stages of 4 self-attention layers and a
    gated cross layer, gates ``MM_GATE``) serving 4 requests (prompts of
    16-64 tokens, 32 generated), each through ``make_prefill`` /
    ``make_decode_step`` (``mm_model``). Weights from seed 0, drawn on the
    card in fp32 and served from a bf16 copy. No plain attention runs on
    the card. Returns {model: launch counts of its timed serve}."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import attention as A
    t0 = time.perf_counter()
    counts = {}
    with count_plain((FA, "attention_causal_plain"),
                     (FA, "attention_noncausal_plain"),
                     (FA, "attention_plain"),
                     (A, "flash_attention_torch")) as plain:
        counts["whisper"] = mm_model(torch, dev, configs.WHISPER_BASE,
                                     "whisper", *MM_WHISPER, seed=21)
        full = configs.LLAMA_3_2_VISION_90B
        free = torch.cuda.mem_get_info(dev)[0]
        stages = MM_VISION_STAGES
        while stages > 1 and 1.5 * vlm_param_bytes(full, stages) > \
                free - MM_MARGIN_GIB * 2 ** 30:
            stages -= 1
        cfg = full.replace(num_layers=stages * full.cross_attn_period)
        all_stages = full.num_layers // full.cross_attn_period
        print(f"vision: reduced: {cfg.num_layers} of {full.num_layers} "
              f"layers ({stages} stage(s) of {full.cross_attn_period - 1} "
              f"self-attention layers and a gated cross layer) at full "
              f"width: the fp32 draw and its bf16 copy need "
              f"{1.5 * vlm_param_bytes(full, stages) / 2 ** 30:.1f} GiB of "
              f"the {free / 2 ** 30:.1f} GiB free ({MM_VISION_STAGES} "
              f"stages asked for); all {full.num_layers} layers in fp32 "
              f"would be {vlm_param_bytes(full, all_stages) / 1e9:.0f} GB, "
              f"more than the card holds", flush=True)
        counts["vision"] = mm_model(torch, dev, cfg, "vision", *MM_VISION,
                                    seed=22)
    require(not any(plain.values()),
            f"multimodal: a plain attention ran on the card: {plain}")
    print(f"multimodal: phase wall {time.perf_counter() - t0:.2f} s",
          flush=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 5: device time by kernel, busy share, host spans (torch.profiler)
# ---------------------------------------------------------------------------
# entry points that run more than one kernel per launch, each named
# ``<entry point>_<part>_kernel``: the causal backward's dQ (with D), then
# dK/dV; the non-causal backward's main pass, then its dQ sum; the scans'
# backward in its chunked form (the training step's) the boundary walk, the
# chunks, then the sum (in its sequential form the walk, then the sum: two,
# which a case of ``check_scan_training`` gives as its
# ``kernels_per_launch``)
KERNELS_PER_LAUNCH = {"flash_prefill_bwd_bf16": 2,
                      "flash_prefill_bwd_bf16/noncausal": 2,
                      "flash_attention_bwd_f32": 2,
                      "mamba_scan_bwd_f32": 3, "wkv6_bwd_f32": 3}
# the names' common part where the default would also take another form's
# kernels: the causal backward's ``_dq_kernel`` and ``_dkdv_kernel``, not
# its non-causal form's ``_noncausal_dq_kernel`` / ``_noncausal_dkdv_kernel``
KERNEL_SYMBOLS = {"flash_prefill_bwd_bf16": "flash_prefill_bwd_bf16_d"}


# entry points with two forms, one kernel a launch chosen by the sequence's
# length (``<entry point>_kernel`` sequential, ``<entry point>_chunked_kernel``)
TWO_FORMS = ("mamba_scan_f32", "wkv6_f32")


def kernel_symbol(entry_point: str) -> str:
    """The CUDA kernel an entry point launches (``csrc/*.cu``), or the
    prefix of its kernels' names; for a form of an entry point
    (``backend.FORMS``), the kernel of its own that the form launches
    (``<entry point>_noncausal_kernel``)."""
    from repro_torch.kernels import backend
    if entry_point in KERNEL_SYMBOLS:
        return KERNEL_SYMBOLS[entry_point]
    if entry_point in backend.FORMS:
        tail = "_" if entry_point in KERNELS_PER_LAUNCH else "_kernel"
        return f"{backend.FORMS[entry_point]}_noncausal{tail}"
    if entry_point in KERNELS_PER_LAUNCH or entry_point in TWO_FORMS:
        return f"{entry_point}_"
    return f"{entry_point}_kernel"


def _device_rows(prof):
    """(name, calls, device us) per profiler entry that ran on the card
    (kernels, copies). The CPU-side operators that launched them carry the
    same device time and are left out, so nothing is counted twice; so are
    the device-side spans of ``record_function`` ranges (an entry that
    shares its name with a host entry), which cover their kernels and the
    gaps between them."""
    from torch.autograd import DeviceType
    avg = prof.key_averages()
    host = {e.key for e in avg if e.device_type == DeviceType.CPU}
    rows = [(e.key, e.count, float(e.self_device_time_total))
            for e in avg
            if e.device_type == DeviceType.CUDA and e.self_device_time_total
            and e.key not in host]
    return sorted(rows, key=lambda r: -r[2])


def _host_rows(prof):
    """(name, calls, host us) per profiler entry that ran on the host
    (operators and CUDA runtime calls), by self time: where the host's
    share of the wall goes (inflated alike by the profiler)."""
    from torch.autograd import DeviceType
    rows = [(e.key, e.count, float(e.self_cpu_time_total))
            for e in prof.key_averages()
            if e.device_type == DeviceType.CPU and e.self_cpu_time_total]
    return sorted(rows, key=lambda r: -r[2])


def report_profile(prof, dt, wall, tracer, n_warm, label, what):
    """Print one profiled serve: device busy time and idle share against
    the profiled wall ``dt`` and the unprofiled median ``wall`` (the
    profiler slows the host, not the card), device time per kernel entry
    point, the engine's host spans after the first ``n_warm``, and the
    largest device and host entries."""
    from repro_torch.kernels import backend
    wall_us = dt * 1e6
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows)
    spans = {}
    for sp in tracer.span_log[n_warm:]:
        spans[sp["name"]] = spans.get(sp["name"], 0.0) + sp["dur_ms"]
    print(f"profile {label} ({what}, {sum(r[1] for r in rows)} device "
          f"launches): wall {wall_us:.0f} us profiled / {wall * 1e6:.0f} us "
          f"unprofiled median, device busy {busy_us:.0f} us, idle share "
          f"{1.0 - busy_us / wall_us:.3f} profiled / "
          f"{1.0 - busy_us / (wall * 1e6):.3f} unprofiled; host spans (ms) "
          + json.dumps({k: round(v, 3) for k, v in spans.items()}),
          flush=True)
    for name in backend.ENTRY_POINTS:
        mine = [r for r in rows if kernel_symbol(name) in r[0]]
        if mine:
            print(f"  {name}: {sum(r[1] for r in mine)} launches, "
                  f"{sum(r[2] for r in mine):.1f} us on the card", flush=True)
    for n, k, us in rows[:12]:
        print(f"  device {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)
    for n, k, us in _host_rows(prof)[:15]:
        print(f"  host   {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)
    return rows, busy_us


def profile_serve(torch, dev, cfg, params, scores, wall, label, soft=False,
                  precision="fp32", granularity="channel"):
    """For one depth-1 serve of a vision path: ``report_profile``."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    from repro_torch.obs import Tracer
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    tracer = Tracer()
    eng = make_engine(cfg, params, scores, 1, dev, tracer=tracer,
                      precision=precision, granularity=granularity)
    serve_stream(torch, backend, eng, soft=soft)  # warm-up
    n_warm = len(tracer.span_log)
    with profile(activities=acts) as prof:
        _, _, dt, counts, pipe = serve_stream(torch, backend, eng, soft=soft)
    report_profile(prof, dt, wall, tracer, n_warm, label,
                   f"depth 1, 16 images, {pipe['steps']} steps")


def profiled_engine(torch, dev, cfg, params):
    """A continuous depth-1 LM engine over the first ``PROFILE_LAYERS``
    layers of ``params``, with a tracer, after a warm-up serve and one
    unprofiled serve. Returns (engine, tracer, that serve's wall, spans
    logged so far)."""
    from repro_torch.kernels import backend
    from repro_torch.obs import Tracer
    tracer = Tracer()
    eng = lm_engine(cfg.replace(num_layers=PROFILE_LAYERS), {
        **params, "layers": params["layers"][:PROFILE_LAYERS]}, dev,
        tracer=tracer)
    serve_lm(torch, backend, eng, True)  # warm-up
    wall = serve_lm(torch, backend, eng, True)[2]
    return eng, tracer, wall, len(tracer.span_log)


def profile_lm(torch, dev, cfg, params):
    """For one depth-1 continuous serve of the LM (``profiled_engine``):
    ``report_profile``, then the causal kernels' device time and
    launches, each and together, against the serve's device busy time."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    eng, tracer, wall, n_warm = profiled_engine(torch, dev, cfg, params)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, dt, _, st = serve_lm(torch, backend, eng, True)
    rows, busy_us = report_profile(
        prof, dt, wall, tracer, n_warm, "lm continuous",
        f"depth 1, {PROFILE_LAYERS} of {cfg.num_layers} layers, 8 requests "
        f"x {LM_MAX_NEW} tokens, {st['pipeline_steps']} steps")
    causal = {name: [(k, us) for n, k, us in rows if kernel_symbol(name) in n]
              for name in ("flash_decode_bf16", "flash_prefill_bf16")}
    parts = [f"{name} {sum(k for k, _ in r)} launches "
             f"{sum(us for _, us in r) / 1e3:.3f} ms"
             for name, r in causal.items()]
    total_us = sum(us for r in causal.values() for _, us in r)
    print(f"profile lm continuous: causal attention {total_us / 1e3:.3f} ms "
          f"of {busy_us / 1e3:.3f} ms device busy "
          f"({total_us / busy_us:.3f}): " + ", ".join(parts), flush=True)


# wrappers whose every call must run exactly one device kernel and nothing
# else (no copy, fill or pre-pass)
ONE_KERNEL_PER_CALL = ("sbmm", "token_drop", "token_package")


def profile_run(torch, dev, checks, cfg, params, scores, walls) -> None:
    """Device time per launch of each kernel entry point at the phase-3
    shapes (stored as ``c["device_ms"]``), the device time of all the
    wrapper call's device work (``c["call_device_ms"]``) and of its library
    call (``c["library_device_ms"]``, all the call's device work); an
    ``sbmm()``, ``token_drop()`` or ``token_package()`` call must run one
    device kernel and nothing else (``ONE_KERNEL_PER_CALL``). Then one
    serve of each path (``profile_serve``)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    n = 20
    for check in checks:
        for c in check.get("cases", [check]):
            sym = kernel_symbol(check["name"])
            # the profiler has been seen to return a window without its
            # device records; such a window is profiled again
            for attempt in range(3):
                with profile(activities=acts) as prof:
                    for _ in range(n):
                        c["fn"]()
                    torch.cuda.synchronize()
                rows = _device_rows(prof)
                mine = [r for r in rows if sym in r[0]]
                if mine:
                    break
                print(f"profile {check['name']}: the profiler recorded no "
                      f"{sym} launch in window {attempt + 1}; profiling "
                      f"again", flush=True)
            require(bool(mine), f"profiler saw no {sym} launch")
            per_launch = c.get("kernels_per_launch",
                               KERNELS_PER_LAUNCH.get(check["name"], 1))
            calls = sum(r[1] for r in mine) / per_launch
            us = sum(r[2] for r in mine)
            if check["name"].startswith(ONE_KERNEL_PER_CALL):
                others = [r for r in rows if sym not in r[0]]
                require(calls <= n and not others,
                        f"{n} calls of {check['name']}'s wrapper ran {calls} "
                        f"{sym} launches and other device work {others}: "
                        f"more than one kernel per call")
            c["device_ms"] = us / calls / 1e3
            c["call_device_ms"] = sum(r[2] for r in rows) / n / 1e3
            c["max_abs_err"] = c["err"]
            c["library_device_ms"] = None
            if c["library_fn"] is not None:
                with profile(activities=acts) as prof:
                    for _ in range(n):
                        c["library_fn"]()
                    torch.cuda.synchronize()
                lib_rows = _device_rows(prof)
                c["library_device_ms"] = sum(r[2] for r in lib_rows) / n / 1e3
            lib = ("" if c["library_device_ms"] is None else
                   f"; library {c['library_device_ms'] * 1e3:.2f} us/call on "
                   f"the card ({sum(r[1] for r in lib_rows) / n:g} device "
                   f"launches per call)")
            print(f"profile {check['name']}"
                  + (f" ({c['label']})" if "label" in c else "")
                  + f": device {us / calls:.2f} us/launch ({calls:g} "
                  f"launches), {c['call_device_ms'] * 1e3:.2f} us/call "
                  f"over all its device work ({sum(r[1] for r in rows) / n:g}"
                  f" device launches per call); wrapper "
                  f"{c['ms'] * 1e3:.2f} us/call" + lib,
                  flush=True)
            if check["name"] in KERNELS_PER_LAUNCH:
                c["device_us_by_kernel"] = {
                    r[0][r[0].index(sym):].split("(")[0]: r[2] / calls
                    for r in mine}
                print(f"  {check['name']} device us/launch by kernel: "
                      + json.dumps({k: round(v, 2) for k, v in
                                    c["device_us_by_kernel"].items()}),
                      flush=True)
        head = check.get("cases", [check])[0]
        check["device_ms"] = head["device_ms"]
        check["call_device_ms"] = head["call_device_ms"]
        check["library_device_ms"] = head["library_device_ms"]
    profile_serve(torch, dev, cfg, params, scores, walls["fp32 depth 1"],
                  "main path fp32")
    for path, precision, granularity in TIERS:
        profile_serve(torch, dev, cfg, params, scores,
                      walls[f"{path} soft"], f"main path {path} soft",
                      soft=True, precision=precision,
                      granularity=granularity)


# ---------------------------------------------------------------------------
# Phase 5b: trace replays (``traffic``) through ``launch/serve_trace``
# ---------------------------------------------------------------------------
TRAFFIC_SEED = 11
TRAFFIC_SIZES = (196, 169, 49)  # full, near-full and half-side images
TRAFFIC_N = 32                  # vision trace length
TRAFFIC_LOAD = 4.0              # offered load over the modeled capacity
TRAFFIC_DEADLINE = 2.0          # vision SLO, in mean service times
TRAFFIC_LIMIT = 4.0             # vision admission budget, the same unit
# the LM trace's admission budget in modeled ms (1 ms per token): the
# first four requests' prompts and tokens fill it, so the rest of the
# burst is refused (4 of 8 at this trace and seed, on any width)
LM_TRAFFIC_LIMIT_MS = 1000.0
# the entry points each trace path must launch in every replay
TRAFFIC_KERNELS = {
    "vision": ("sbmm_f32", "flash_attention_f32", "token_drop_f32",
               "token_package_f32"),
    "lm": ("flash_prefill_bf16", "flash_decode_bf16"),
}
REPORT_KEYS = ("latency_p50_ms", "latency_p95_ms", "latency_p99_ms",
               "ttfd_p50_ms", "goodput_rps", "deadline_miss_rate",
               "peak_queue_depth", "rejected")


def traffic_driver(kind, depth, dev, quality="strict", reduced=False):
    """``serve_trace.build_driver`` at the phase's settings: 4 slots, seed
    0 (the main path's DeiT-Small weights and scores; StableLM-1.6B drawn
    on ``dev``), the LM's 572-slot cache, 1 modeled ms per LM token."""
    from repro_torch.launch.serve_trace import build_driver
    arch = "deit-small" if kind == "vision" else "stablelm-1.6b"
    return build_driver(kind, arch, 4, 0, depth, quality, 0.4, 1.0,
                        reduced=reduced, max_len=LM_MAX_LEN, device=dev)


def lm_driver_like(drv, depth):
    """A fresh LM driver (its own scheduler, cache and pipeline) at
    pipeline depth ``depth`` serving ``drv``'s weights: the engine's bf16
    copy, shared and not drawn again."""
    from repro_torch.serving import ServeEngine
    from repro_torch.traffic import LMDriver
    eng = drv.engine
    ec = dataclasses.replace(eng.ec, pipeline_depth=depth)
    return LMDriver(ServeEngine(eng.cfg, eng.params, ec, device=eng.device),
                    per_token_ms=drv.per_token_ms)


def replay(torch, backend, driver, trace, limit=None):
    """Replay ``trace`` through ``driver`` on the card: launch counts set to
    0 just before and read just after, the host's waits on the card
    besides the step events counted by PyTorch's sync debug mode. Returns
    (harness, report, wall seconds, launch counts, host syncs)."""
    from repro_torch.traffic import TrafficHarness
    harness = TrafficHarness(driver, admission_limit_ms=limit)
    rep, dt, counts, syncs = timed_window(torch, backend,
                                          lambda: harness.run(trace))
    return harness, rep, dt, counts, syncs


def check_replay(kind, label, trace, harness, rep, dt, counts, syncs):
    """Gates (a) and (b) of one replay, then its printed line: every
    kernel of the path launched, every admitted request completed (finite
    logits of the model's classes, or every token)."""
    import numpy as np
    n = len(trace.requests)
    for name in TRAFFIC_KERNELS[kind]:
        require(counts[name] > 0, f"traffic {label}: kernel {name} never "
                                  f"launched during the replay")
    served = set(range(n)) - {r.uid for r in harness.records.values()
                              if r.rejected}
    require(rep["completed"] + rep["rejected"] == n
            and set(harness.outputs) == served,
            f"traffic {label}: {rep['completed']} completed and "
            f"{rep['rejected']} rejected of {n}")
    for uid, out in harness.outputs.items():
        if kind == "vision":
            ok = out.shape == (harness.driver.engine.cfg.num_classes,) \
                and bool(np.isfinite(out).all())
        else:
            ok = len(out) == trace.requests[uid].max_new_tokens
        require(ok, f"traffic {label}: uid {uid} has no full output")
    print(f"traffic {label}: "
          + ", ".join(f"{k}={rep[k]:.6g}" for k in REPORT_KEYS)
          + f"; fingerprint {trace.fingerprint()}; wall {dt:.4f} s; "
          f"launches { {k: v for k, v in counts.items() if v} }; host "
          f"syncs besides the step events {syncs}", flush=True)


def check_rejections(label, harness):
    """Gate (g): the budget refused at least one request, and a refused
    uid has no output and never took a slot."""
    rejected = {d.uid for d in harness.controller.decisions
                if d.action == "reject"}
    admitted = {u for kind, u in harness.driver.scheduler.events
                if kind == "admit"}
    require(bool(rejected), f"traffic {label}: the admission budget "
                            f"rejected nothing")
    require(not rejected & (set(harness.outputs) | admitted),
            f"traffic {label}: a rejected uid has an output or a slot")
    print(f"traffic {label}: admission {harness.controller.stats()}",
          flush=True)


def same_replays(label, a, b, rep_a, rep_b, digests=True):
    """Gate (c) / (f): equal lifecycles ``a`` and ``b``, reports equal
    apart from the outputs digest (and, with ``digests``, equal digests
    too)."""
    require(a == b, f"traffic {label}: lifecycles differ")
    strip = [{k: v for k, v in r.items() if k != "outputs_digest"}
             for r in (rep_a, rep_b)]
    require(strip[0] == strip[1], f"traffic {label}: reports differ")
    if digests:
        require(rep_a["outputs_digest"] == rep_b["outputs_digest"],
                f"traffic {label}: outputs digests differ")
    print(f"traffic {label}: lifecycles and reports identical"
          + (" (outputs digests too)" if digests else ""), flush=True)


def traffic_vision(torch, dev):
    """Full-width DeiT-Small replaying a bursty trace at 4x its modeled
    capacity. Returns (launch counts of the depth-1 replay, {replay: host
    syncs})."""
    import numpy as np
    from repro_torch.kernels import backend
    from repro_torch.traffic import TraceSpec, make_trace
    # saturation capacity on the virtual clock: a back-to-back replay
    probe = TraceSpec(n=16, rate_rps=1e6, process="poisson",
                      sizes=TRAFFIC_SIZES, r_ts=(None,), deadlines_ms=(None,))
    h, rep, _, _, _ = replay(torch, backend, traffic_driver("vision", 1, dev),
                             make_trace(probe, seed=TRAFFIC_SEED + 101))
    capacity, service_ms = rep["throughput_rps"], rep["virtual_ms"] / probe.n
    spec = TraceSpec(kind="vision", process="bursty", n=TRAFFIC_N,
                     rate_rps=TRAFFIC_LOAD * capacity, sizes=TRAFFIC_SIZES,
                     r_ts=(None, 0.7, 0.5), soft_prob=0.5,
                     deadlines_ms=(TRAFFIC_DEADLINE * service_ms, None))
    trace = make_trace(spec, seed=TRAFFIC_SEED)
    print(f"traffic vision: modeled capacity {capacity:.6g} requests/s, mean "
          f"service {service_ms:.6g} ms (probe: 16 back-to-back requests); "
          f"trace {TRAFFIC_N} bursty requests at {spec.rate_rps:.6g}/s, "
          f"deadline {spec.deadlines_ms[0]:.6g} ms on half", flush=True)
    runs, syncs = {}, {}
    for label, depth, quality, limit in (
            ("depth 1", 1, "strict", None), ("depth 2", 2, "strict", None),
            ("admission", 1, "auto", TRAFFIC_LIMIT * service_ms)):
        drv = traffic_driver("vision", depth, dev, quality=quality)
        h, rep, dt, counts, n_syncs = replay(torch, backend, drv, trace,
                                             limit)
        check_replay("vision", f"vision {label}", trace, h, rep, dt, counts,
                     n_syncs)
        if limit is not None:
            check_rejections(f"vision {label}", h)
        if label == "depth 1":
            drv1 = drv
        runs[label] = (h.lifecycle(), rep, h.outputs, counts)
        syncs[f"traffic vision {label}"] = [n_syncs]
    (life1, rep1, out1, counts1), (life2, rep2, _, _) = (runs["depth 1"],
                                                         runs["depth 2"])
    require(rep1["rejected"] == 0, "traffic vision: a rejection without a "
                                   "budget")
    same_replays("vision depth 1 vs 2", life1, life2, rep1, rep2)
    reqs = [drv1.materialize(tr) for tr in trace.requests]
    check_against_oracle(torch, drv1.engine.cfg, drv1.engine, reqs, out1,
                         "fp32", "traffic vision depth 1")
    direct = traffic_driver("vision", 1, dev)
    out = direct.engine.serve([direct.materialize(tr)
                               for tr in trace.requests])
    tol, worst = ORACLE_TOL["fp32"], 0.0
    for uid, ref in out.items():
        got = out1[uid]
        err = float(np.abs(got - ref).max()) / max(1.0, float(
            np.abs(ref).max()))
        worst = max(worst, err)
        require(err <= tol and int(np.argmax(got)) == int(np.argmax(ref)),
                f"traffic vision: uid {uid}: replay vs direct serve "
                f"max|d|/max(1,max|ref|)={err:.3g} (tolerance {tol}) or "
                f"top-1 differs")
    print(f"traffic vision: replay vs direct serve() of the same requests: "
          f"top-1 {len(out)}/{len(out)} equal, max|d|/max(1,max|ref|) = "
          f"{worst:.3g} (tolerance {tol})", flush=True)
    cpu_h, cpu_rep, cpu_dt, _, _ = replay(torch, backend, traffic_driver(
        "vision", 1, "cpu"), trace)
    same_replays(f"vision card vs CPU (full width; CPU replay wall "
                 f"{cpu_dt:.2f} s)", life1, cpu_h.lifecycle(), rep1, cpu_rep,
                 digests=False)
    return counts1, syncs


def traffic_lm(torch, dev, checks):
    """Full-width StableLM-1.6B replaying a bursty trace of 8 requests.
    Returns (launch counts of the depth-1 replay, {replay: host syncs})."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    from repro_torch.traffic import TraceSpec, make_trace
    spec = TraceSpec(kind="lm", process="bursty", n=8, rate_rps=150.0,
                     prompt_sizes=LM_PROMPTS, max_new_tokens=LM_MAX_NEW,
                     deadlines_ms=(400.0, None))
    trace = make_trace(spec, seed=TRAFFIC_SEED)
    # the weights are drawn once, by the first replay's driver; every later
    # engine serves them from its own scheduler, cache and pipeline
    drv1 = traffic_driver("lm", 1, dev)
    runs, syncs = {}, {}
    for label, depth, limit in (("depth 1", 1, None), ("depth 2", 2, None),
                                ("admission", 1, LM_TRAFFIC_LIMIT_MS)):
        drv = drv1 if label == "depth 1" else lm_driver_like(drv1, depth)
        h, rep, dt, counts, n_syncs = replay(torch, backend, drv, trace,
                                             limit)
        check_replay("lm", f"lm {label}", trace, h, rep, dt, counts, n_syncs)
        st, layers = drv.engine.stats(), drv.engine.cfg.num_layers
        calls = st["runner_prefill_calls"] + st["runner_prefill_slot_calls"]
        require(counts["flash_prefill_bf16"] == layers * calls
                and counts["flash_decode_bf16"]
                == layers * st["runner_decode_calls"],
                f"traffic lm {label}: causal launches {counts} are not one "
                f"per layer of every prefill ({calls}) and decode "
                f"({st['runner_decode_calls']}) call")
        if limit is not None:
            check_rejections(f"lm {label}", h)
        runs[label] = (h.lifecycle(), rep, h.outputs, counts)
        syncs[f"traffic lm {label}"] = [n_syncs]
    (life1, rep1, out1, counts1), (life2, rep2, out2, _) = (runs["depth 1"],
                                                            runs["depth 2"])
    require(rep1["rejected"] == 0, "traffic lm: a rejection without a budget")
    require(out1 == out2, "traffic lm: depth 1 and 2 tokens differ")
    same_replays("lm depth 1 vs 2", life1, life2, rep1, rep2)
    eng = drv1.engine
    reqs = [drv1.materialize(tr) for tr in trace.requests]
    for r in reqs:
        r.generated = list(out1[r.uid])
    check_lm_oracle(torch, eng.cfg, eng.params, reqs, dev,
                    "traffic lm depth 1")
    direct = lm_driver_like(drv1, 1)
    out = direct.engine.serve([direct.materialize(tr)
                               for tr in trace.requests], continuous=True)
    require(out == out1, "traffic lm: replay and direct serve() "
                         "tokens differ")
    print("traffic lm: replay and direct serve() of the same requests: "
          "tokens identical (8/8)", flush=True)
    cpu_h, cpu_rep, cpu_dt, _, _ = replay(torch, backend, traffic_driver(
        "lm", 1, "cpu", reduced=True), trace)
    same_replays(f"lm card (full width) vs CPU (reduced; CPU replay wall "
                 f"{cpu_dt:.2f} s)", life1, cpu_h.lifecycle(), rep1, cpu_rep,
                 digests=False)
    # the causal kernels' device time per launch over one profiled depth-1
    # replay (a fresh engine), beside their Dh-64 serve cases of phase 3
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(3):  # a window may lack its device records
        with profile(activities=acts) as prof:
            replay(torch, backend, lm_driver_like(drv1, 1), trace)
        rows = _device_rows(prof)
        if all(any(kernel_symbol(k) in r[0] for r in rows)
               for k in TRAFFIC_KERNELS["lm"]):
            break
        print(f"profile traffic lm: window {attempt + 1} lacks a causal "
              f"kernel's records; profiling again", flush=True)
    busy_us = sum(r[2] for r in rows)
    print(f"profile traffic lm depth 1: device busy {busy_us / 1e3:.3f} ms",
          flush=True)
    for c in checks:
        if c["name"] not in TRAFFIC_KERNELS["lm"]:
            continue
        mine = [r for r in rows if kernel_symbol(c["name"]) in r[0]]
        n, us = sum(r[1] for r in mine), sum(r[2] for r in mine)
        case = next(k for k in c["cases"] if "Dh 64" in k["label"])
        require(n > 0, f"profile traffic lm: no {c['name']} launch seen")
        print(f"  {c['name']} at Dh 64: {n} launches profiled ("
              f"{counts1[c['name']]} in the unprofiled replay), "
              f"{us / n:.2f} us per launch on the card over the replay; at "
              f"its Dh 64 serve "
              f"case ({case['shapes']}): device "
              f"{case['device_ms'] * 1e3:.2f} us per launch, SDPA "
              f"{case['library_device_ms'] * 1e3:.2f} us per call, bound "
              f"{case['bound_ms'] * 1e3:.2f} us ({case['bound_by']})",
              flush=True)
    return counts1, syncs


def traffic_path(torch, dev, checks):
    """Phase 5b. Returns ({path: launch counts of its depth-1 replay},
    {replay: host syncs})."""
    t0 = time.perf_counter()
    vision_counts, syncs = traffic_vision(torch, dev)
    lm_counts, lm_syncs = traffic_lm(torch, dev, checks)
    syncs.update(lm_syncs)
    torch.cuda.empty_cache()
    print(f"traffic: phase wall {time.perf_counter() - t0:.2f} s", flush=True)
    return {"traffic vision": vision_counts, "traffic lm": lm_counts}, syncs


# LM training's causal kernel pair at StableLM-1.6B's shape (32 heads, MHA,
# Dh 64, batch 8 x 512 tokens), at a GQA shape (24 query over 8 KV heads),
# at Granite-MoE-3B-A800M's training step (that GQA shape at 8 x 512), at
# Llama-3.2-Vision-90B's self-attention (64 query over 8 KV heads of Dh
# 128, 8 x 512) and at Dh 128 with a ragged last tile; the first case of
# the backward is its headline
LM_TRAIN_CASES = (("StableLM-1.6B", 8, 512, 32, 32, 64),
                  ("GQA 3:1", 2, 512, 24, 8, 64),
                  ("Granite-MoE-3B-A800M", 8, 512, 24, 8, 64),
                  ("Llama-3.2-Vision-90B self", 8, 512, 64, 8, 128),
                  ("Dh 128, 130 positions", 2, 130, 16, 2, 128))
LSE_TOL = 1e-5  # x max(1, max|plain lse|): fp32 sums in another order


def check_causal_training(torch, dev, prefill):
    """The causal kernels of LM training, through the wrappers
    ``CausalAttention`` calls, against their plain versions at
    ``LM_TRAIN_CASES``:

    * the forward writing the log-sum-exp (``flash_prefill_bf16`` with
      ``lse``; appended to the ``prefill`` check as a case): o within one
      bf16 ulp of the largest plain element, lse within ``LSE_TOL``, and o
      bitwise the serve's (the same call with a null lse);
    * ``flash_prefill_bwd_bf16`` (two kernels per launch: dQ with D, then
      dK/dV)
      against ``attention_causal_bwd_plain`` on the same o, dO and lse: dq,
      dk, dv each within one bf16 ulp of its largest plain element, two
      launches bitwise equal. Its library call is SDPA's forward and
      backward (``is_causal=True``), timed only.

    Returns the backward's check, one entry per case under ``cases``."""
    import torch.nn.functional as F
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    g = torch.Generator().manual_seed(9)
    cases = []
    for label, B, N, Hq, KV, Dh in LM_TRAIN_CASES:
        q, do = (torch.randn((B, N, Hq, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, N, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        shapes = (f"q,o,dO[{B},{N},{Hq},{Dh}] k,v[{B},{N},{KV},{Dh}] bf16 "
                  f"causal")
        # every (row, head, key) pair of the causal triangle
        pairs = B * Hq * N * (N + 1) // 2
        qkv_bytes = 2 * (2 * q.numel() + 2 * k.numel())
        gqa = KV != Hq

        def fwd(q=q, k=k, v=v):
            return FA._causal_cuda(q, k, v, None, None, None, False,
                                   with_lse=True)

        def fwd_plain(q=q, k=k, v=v):
            return (FA.attention_causal_plain(q, k, v)[0],
                    FA.attention_causal_lse_plain(q, k))

        before = backend.launches()
        (o, lse), (o_ref, lse_ref) = fwd(), fwd_plain()
        o_serve, _ = FA._causal_cuda(q, k, v, None, None, None, False)
        torch.cuda.synchronize()
        require(backend.launches()["flash_prefill_bf16"]
                == before["flash_prefill_bf16"] + 2,
                f"flash_prefill_bf16 ({label}) did not launch")
        require(torch.equal(o, o_serve),
                f"flash_prefill_bf16 ({label}): o with lse is not the "
                f"serve's o bit for bit")
        err_lse = (lse - lse_ref).abs().max().item()
        tol_lse = LSE_TOL * max(1.0, lse_ref.abs().max().item())
        qh, kh, vh, doh = (t.transpose(1, 2).detach().clone()
                           for t in (q, k, v, do))
        if prefill is not None:
            # Q.K and P.V, 2 Dh each at the bf16 rate, and ~4 for the
            # softmax a pair; bytes: q, k, v and o once, lse once
            n_bytes = qkv_bytes + 4 * B * Hq * N
            bnd, by = bound_ms(n_bytes, 4 * pairs, 4 * Dh * pairs)

            def sdpa_fwd(qh=qh, kh=kh, vh=vh, gqa=gqa):
                return F.scaled_dot_product_attention(
                    qh, kh, vh, is_causal=True, enable_gqa=gqa)

            case = dict(
                label=f"train {label}, with lse", fn=fwd, ms=time_ms(fwd),
                plain_ms=time_ms(fwd_plain), library_fn=sdpa_fwd,
                library_ms=time_ms(sdpa_fwd), bound_ms=bnd, bound_by=by,
                errs=[(f"o (train {label})",
                       (o.float() - o_ref.float()).abs().max().item(),
                       BF16_ULP * o_ref.float().abs().max().item(),
                       "one bf16 ulp at max|plain|"),
                      (f"lse (train {label})", err_lse, tol_lse,
                       f"{LSE_TOL:g} x max(1, max|plain|)")],
                shapes=shapes + " (+lse; o bitwise the serve's)")
            prefill["cases"].append(case)
            prefill["errs"].extend(case["errs"])
            prefill["shapes"] += f"; {case['label']}: {case['shapes']}"

        def bwd(q=q, k=k, v=v, o=o, do=do, lse=lse):
            return FA._causal_bwd_cuda(q, k, v, o, do, lse, None)

        def bwd_plain(q=q, k=k, v=v, o=o, do=do, lse=lse):
            return FA.attention_causal_bwd_plain(q, k, v, o, do, lse)

        before = backend.launches()["flash_prefill_bwd_bf16"]
        res, again, ref = bwd(), bwd(), bwd_plain()
        torch.cuda.synchronize()
        require(backend.launches()["flash_prefill_bwd_bf16"] == before + 2,
                f"flash_prefill_bwd_bf16 ({label}) did not launch")
        require(all(torch.equal(a, b) for a, b in zip(res, again)),
                f"flash_prefill_bwd_bf16 ({label}): two launches differ")
        errs = []
        for name, a, r in zip(("dq", "dk", "dv"), res, ref):
            require(a.dtype == torch.bfloat16
                    and bool(torch.isfinite(a.float()).all()),
                    f"flash_prefill_bwd_bf16 ({label}): {name} {a.dtype} "
                    f"or not finite")
            errs.append((f"{name} ({label})",
                         (a.float() - r.float()).abs().max().item(),
                         BF16_ULP * r.float().abs().max().item(),
                         "one bf16 ulp at max|plain|"))
        # bytes: q, o, dO, k, v (bf16) and lse (fp32) read once, dq, dk, dv
        # (bf16) written once; operations per causal pair: the five products
        # Q.K^T, dO.V^T, P^T.dO, dS^T.Q and dS.K (2 Dh each, the bf16
        # tensor-core rate), ~8 fp32 for the exponential and dS
        n_bytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * B * Hq * N
        bnd, by = bound_ms(n_bytes, 8 * pairs, 10 * Dh * pairs)
        leaves_h = [t.clone().requires_grad_(True) for t in (qh, kh, vh)]

        def sdpa(leaves_h=leaves_h, doh=doh, gqa=gqa):
            out = F.scaled_dot_product_attention(*leaves_h, is_causal=True,
                                                 enable_gqa=gqa)
            return torch.autograd.grad(out, leaves_h, doh)

        cases.append(dict(
            label=label, errs=errs, fn=bwd, ms=time_ms(bwd),
            plain_ms=time_ms(bwd_plain, samples=5, calls=3, warmup=1),
            library_fn=sdpa, library_ms=time_ms(sdpa), bound_ms=bnd,
            bound_by=by, shapes=shapes + " backward"))
    head = cases[0]
    return dict(
        name="flash_prefill_bwd_bf16", source="flash_prefill_bwd.cu",
        errs=[e for c in cases for e in c["errs"]], fn=head["fn"],
        ms=head["ms"], plain_ms=head["plain_ms"],
        library_fn=head["library_fn"], library_ms=head["library_ms"],
        library_call="F.scaled_dot_product_attention(is_causal=True) "
                     "forward + backward on bf16 (timing only)",
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cases),
        cases=cases)


# The non-causal training pair (``NonCausalGQAAttention``): (label, B, Nq,
# Nk, Hq, KV, Dh) at the VLM and audio families' training steps (batch 8 x
# 512: Whisper-base's encoder over its 1500 frames and its decoder's 64
# tokens against them, Llama-3.2-Vision-90B's cross layer, 512 tokens
# against 1601 vision tokens), then the ragged tiles at Dh 16: fewer rows
# than a tile against more keys than one, and 65 keys (one past a tile)
# under GQA 8:1; the first case is the backward's headline
MM_TRAIN_CASES = (("whisper encoder", 8, 1500, 1500, 8, 8, 64),
                  ("whisper cross", 8, 64, 1500, 8, 8, 64),
                  ("vision cross", 8, 512, 1601, 64, 8, 128),
                  ("Dh 16, Nq 5 < 64 < Nk 65", 3, 5, 65, 4, 1, 16),
                  ("Dh 16, 70 rows over 65 keys, GQA 8:1", 2, 70, 65, 8, 1,
                   16))


def check_noncausal_training(torch, dev, prefill):
    """The non-causal kernels of the VLM and audio families' training,
    through the wrappers ``NonCausalGQAAttention`` calls, against their
    plain versions at ``MM_TRAIN_CASES``:

    * the prefill form writing the log-sum-exp (``flash_prefill_bf16``
      with ``causal`` 0 and ``lse``; appended to the ``prefill`` check, the
      form ``flash_prefill_bf16/noncausal``, as a case): o within one bf16
      ulp of the largest plain element, lse within ``LSE_TOL``, and o
      bitwise the serve's (the same call with a null lse);
    * ``flash_prefill_bwd_bf16`` with ``causal`` 0 (the form
      ``flash_prefill_bwd_bf16/noncausal``; two kernels per launch) against
      ``attention_noncausal_bwd_plain`` on the same o, dO and lse: dq, dk,
      dv each within one bf16 ulp of its largest plain element, two
      launches bitwise equal, each counted once under the form. Its library
      call is SDPA's forward and backward (``enable_gqa=True``), timed
      only.

    Returns the backward form's check, one entry per case under
    ``cases``."""
    import torch.nn.functional as F
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    form = FA.NONCAUSAL_BWD_FORM
    g = torch.Generator().manual_seed(10)
    cases = []
    for label, B, Nq, Nk, Hq, KV, Dh in MM_TRAIN_CASES:
        q, do = (torch.randn((B, Nq, Hq, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Nk, KV, Dh), generator=g).to(
            dev, torch.bfloat16) for _ in range(2))
        shapes = (f"q,o,dO[{B},{Nq},{Hq},{Dh}] k,v[{B},{Nk},{KV},{Dh}] "
                  f"bf16 non-causal")
        pairs = B * Hq * Nq * Nk
        qkv_bytes = 2 * (2 * q.numel() + 2 * k.numel())

        def fwd(q=q, k=k, v=v):
            return FA._noncausal_cuda(q, k, v, with_lse=True)

        def fwd_plain(q=q, k=k, v=v):
            return (FA.attention_noncausal_plain(q, k, v),
                    FA.attention_noncausal_lse_plain(q, k))

        before = backend.form_launches()
        (o, lse), (o_ref, lse_ref) = fwd(), fwd_plain()
        o_serve = FA._noncausal_cuda(q, k, v)
        torch.cuda.synchronize()
        require(backend.form_launches()["flash_prefill_bf16/noncausal"]
                == before["flash_prefill_bf16/noncausal"] + 2,
                f"flash_prefill_bf16/noncausal ({label}) did not launch")
        require(torch.equal(o, o_serve),
                f"flash_prefill_bf16/noncausal ({label}): o with lse is not "
                f"the serve's o bit for bit")
        err_lse = (lse - lse_ref).abs().max().item()
        tol_lse = LSE_TOL * max(1.0, lse_ref.abs().max().item())
        qh, kh, vh, doh = (t.transpose(1, 2).detach().clone()
                           for t in (q, k, v, do))
        # Q.K and P.V, 2 Dh each at the bf16 rate, and ~4 for the softmax
        # a pair; bytes: q, k, v and o once, lse once
        n_bytes = qkv_bytes + 4 * B * Hq * Nq
        bnd, by = bound_ms(n_bytes, 4 * pairs, 4 * Dh * pairs)

        def sdpa_fwd(qh=qh, kh=kh, vh=vh):
            return F.scaled_dot_product_attention(qh, kh, vh,
                                                  enable_gqa=True)

        case = dict(
            label=f"train {label}, with lse", fn=fwd, ms=time_ms(fwd),
            plain_ms=time_ms(fwd_plain, samples=5, calls=3, warmup=1),
            library_fn=sdpa_fwd, library_ms=time_ms(sdpa_fwd), bound_ms=bnd,
            bound_by=by,
            errs=[(f"o (train {label})",
                   (o.float() - o_ref.float()).abs().max().item(),
                   BF16_ULP * o_ref.float().abs().max().item(),
                   "one bf16 ulp at max|plain|"),
                  (f"lse (train {label})", err_lse, tol_lse,
                   f"{LSE_TOL:g} x max(1, max|plain|)")],
            shapes=shapes + " (+lse; o bitwise the serve's)")
        prefill["cases"].append(case)
        prefill["errs"].extend(case["errs"])
        prefill["shapes"] += f"; {case['label']}: {case['shapes']}"

        def bwd(q=q, k=k, v=v, o=o, do=do, lse=lse):
            return FA._prefill_bwd_cuda(q, k, v, o, do, lse, None,
                                        causal=False)

        def bwd_plain(q=q, k=k, v=v, o=o, do=do, lse=lse):
            return FA.attention_noncausal_bwd_plain(q, k, v, o, do, lse)

        before, forms = backend.launches(), backend.form_launches()
        res, again, ref = bwd(), bwd(), bwd_plain()
        torch.cuda.synchronize()
        require(backend.form_launches()[form] == forms[form] + 2
                and sum(backend.launches().values())
                == sum(before.values()) + 2,
                f"{form} ({label}) did not launch once a call")
        require(all(torch.equal(a, b) for a, b in zip(res, again)),
                f"{form} ({label}): two launches differ")
        errs = []
        for name, a, r in zip(("dq", "dk", "dv"), res, ref):
            require(a.dtype == torch.bfloat16 and a.shape == r.shape
                    and bool(torch.isfinite(a.float()).all()),
                    f"{form} ({label}): {name} {a.dtype} {tuple(a.shape)} "
                    f"or not finite")
            errs.append((f"{name} ({label})",
                         (a.float() - r.float()).abs().max().item(),
                         BF16_ULP * r.float().abs().max().item(),
                         "one bf16 ulp at max|plain|"))
        # bytes: q, o, dO, k, v (bf16) and lse (fp32) read once, dq, dk, dv
        # (bf16) written once; operations per (row, head, key) pair: the
        # five products (2 Dh each, the bf16 tensor-core rate), ~8 fp32 for
        # the exponential and dS
        n_bytes = 2 * (4 * q.numel() + 4 * k.numel()) + 4 * B * Hq * Nq
        bnd, by = bound_ms(n_bytes, 8 * pairs, 10 * Dh * pairs)
        leaves_h = [t.clone().requires_grad_(True) for t in (qh, kh, vh)]

        def sdpa(leaves_h=leaves_h, doh=doh):
            out = F.scaled_dot_product_attention(*leaves_h, enable_gqa=True)
            return torch.autograd.grad(out, leaves_h, doh)

        cases.append(dict(
            label=label, errs=errs, fn=bwd, ms=time_ms(bwd),
            plain_ms=time_ms(bwd_plain, samples=5, calls=3, warmup=1),
            library_fn=sdpa, library_ms=time_ms(sdpa), bound_ms=bnd,
            bound_by=by, shapes=shapes + " backward"))
        del res, again, ref
    head = cases[0]
    return dict(
        name=form, source="flash_prefill_bwd.cu",
        errs=[e for c in cases for e in c["errs"]], fn=head["fn"],
        ms=head["ms"], plain_ms=head["plain_ms"],
        library_fn=head["library_fn"], library_ms=head["library_ms"],
        library_call="F.scaled_dot_product_attention(enable_gqa=True) "
                     "forward + backward on bf16 (timing only)",
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cases),
        cases=cases)


# Algorithm 1's attention and TDM shapes at full-width DeiT-Small, batch 64
# (``TRAIN_BATCH``): (label, B, N, H, Dh) per span of layers between TDMs,
# then N = 33 (one row past the backward's 32-row query tiles) and the
# reduced config's; the first case of each kernel is its headline
VIT_ATTN_CASES = (("layers 0-2", 64, 197, 6, 64),
                  ("layers 3-6", 64, 140, 6, 64),
                  ("layers 7-9", 64, 100, 6, 64),
                  ("layers 10-11", 64, 72, 6, 64),
                  ("N = 33", 64, 33, 6, 64),
                  ("reduced", 8, 17, 4, 16))
# (label, B, N, D, k) per TDM: layers 2, 6 and 9, then the reduced config's
VIT_TDM_CASES = (("layer 2", 64, 197, 384, 138),
                 ("layer 6", 64, 140, 384, 98),
                 ("layer 9", 64, 100, 384, 70),
                 ("reduced", 8, 17, 64, 12))
# fp32 sums in another order: the attention backward's outputs within 1e-5
# of max(1, max|plain|), the token-drop backward's dropped rows and
# dscores within 1e-6 of it (CLS and kept rows bitwise)
VIT_BWD_TOL = 1e-5
TDM_BWD_TOL = 1e-6


def _as_cases(check):
    """The check's own measurement as its first case (``serve``), so that
    training cases can follow it under ``cases``."""
    if "cases" not in check:
        check["cases"] = [{**check, "label": "serve"}]
    return check["cases"]


def check_vit_attention_training(torch, dev, fwd_check):
    """The non-causal attention of Algorithm 1's training, through the
    functions ``NonCausalAttention`` calls, against the plain versions at
    ``VIT_ATTN_CASES``:

    * ``flash_attention_f32`` writing the log-sum-exp (a case of
      ``fwd_check`` per shape): o and the CLS probabilities bitwise the
      serve's (the same call with a null lse), lse within ``LSE_TOL``;
    * ``flash_attention_bwd_f32`` (two kernels per launch: the main pass
      and the sum of its per-key-tile dQ partials) against
      ``attention_bwd_plain`` on the same o, dO and lse, with the CLS
      probabilities' gradient (dscores / H at every head, the broadcast
      view the training step passes) and without: dq, dk, dv within
      ``VIT_BWD_TOL`` x max(1, max|plain|), two launches bitwise equal.
      Its library call is SDPA's fp32 forward and backward, timed only.
      Prints each case's time over its bound and over SDPA's.

    Returns the backward's check, one entry per case under ``cases``."""
    import torch.nn.functional as F
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    g = torch.Generator().manual_seed(12)
    fwd_cases = _as_cases(fwd_check)
    cases = []
    for label, B, N, H, Dh in VIT_ATTN_CASES:
        q, k, v, do = (torch.randn((B, N, H, Dh), generator=g).to(dev)
                       for _ in range(4))
        dsc = torch.randn((B, N), generator=g).to(dev)
        dprobs = (dsc[:, None, :] / H).expand(B, H, N)
        shapes = f"q,k,v,o,dO[{B},{N},{H},{Dh}] fp32 non-causal"
        pairs = B * H * N * N

        def fwd(q=q, k=k, v=v):
            return FA._attention_cuda(q, k, v, None, True, with_lse=True)

        def fwd_plain(q=q, k=k, v=v):
            o, probs = FA.attention_plain(q, k, v)
            return o, probs, FA.attention_lse_plain(q, k)

        before = backend.launches()["flash_attention_f32"]
        o, probs, lse = fwd()
        o_serve, probs_serve, _ = FA._attention_cuda(q, k, v, None, True)
        o_ref, probs_ref, lse_ref = fwd_plain()
        torch.cuda.synchronize()
        require(backend.launches()["flash_attention_f32"] == before + 2,
                f"flash_attention_f32 ({label}, lse) did not launch")
        require(torch.equal(o, o_serve) and torch.equal(probs, probs_serve),
                f"flash_attention_f32 ({label}): o or probs with lse are not "
                f"the serve's bit for bit")
        require(bool(torch.isfinite(lse).all()),
                f"flash_attention_f32 ({label}): lse not finite")
        n_bytes = 4 * (4 * q.numel() + 2 * B * H * N)
        bnd, by = bound_ms(n_bytes, 4 * Dh * pairs)
        qh, kh, vh, doh = (t.transpose(1, 2).contiguous()
                           for t in (q, k, v, do))

        def sdpa_fwd(qh=qh, kh=kh, vh=vh):
            return F.scaled_dot_product_attention(qh, kh, vh)

        fwd_cases.append(dict(
            label=f"train {label}, with lse", fn=fwd, ms=time_ms(fwd),
            plain_ms=time_ms(fwd_plain, samples=5, calls=3, warmup=1),
            library_fn=sdpa_fwd, library_ms=time_ms(sdpa_fwd), bound_ms=bnd,
            bound_by=by,
            errs=[(f"o (train {label})",
                   (o - o_ref).abs().max().item(),
                   1e-4 * o_ref.abs().max().item(), "1e-4 x max|plain|"),
                  (f"lse (train {label})", (lse - lse_ref).abs().max().item(),
                   LSE_TOL * max(1.0, lse_ref.abs().max().item()),
                   f"{LSE_TOL:g} x max(1, max|plain|)")],
            shapes=shapes + " (+lse, +probs; o, probs bitwise the serve's)"))
        fwd_check["errs"].extend(fwd_cases[-1]["errs"])

        def bwd(q=q, k=k, v=v, o=o, do=do, lse=lse, dprobs=dprobs):
            return FA._attention_bwd_cuda(q, k, v, o, do, lse, dprobs)

        def bwd_plain(q=q, k=k, v=v, o=o, do=do, lse=lse, dprobs=dprobs):
            return FA.attention_bwd_plain(q, k, v, o, do, lse, dprobs)

        before = backend.launches()["flash_attention_bwd_f32"]
        res, again, ref = bwd(), bwd(), bwd_plain()
        res0 = FA._attention_bwd_cuda(q, k, v, o, do, lse, None)
        ref0 = FA.attention_bwd_plain(q, k, v, o, do, lse, None)
        torch.cuda.synchronize()
        require(backend.launches()["flash_attention_bwd_f32"] == before + 3,
                f"flash_attention_bwd_f32 ({label}) did not launch")
        require(all(torch.equal(a, b) for a, b in zip(res, again)),
                f"flash_attention_bwd_f32 ({label}): two launches differ")
        errs = []
        for tag, got, want in (("", res, ref), (", no dprobs", res0, ref0)):
            for name, a, r in zip(("dq", "dk", "dv"), got, want):
                require(a.dtype == torch.float32
                        and bool(torch.isfinite(a).all()),
                        f"flash_attention_bwd_f32 ({label}): {name} "
                        f"{a.dtype} or not finite")
                errs.append((f"{name} ({label}{tag})",
                             (a - r).abs().max().item(),
                             VIT_BWD_TOL * max(1.0, r.abs().max().item()),
                             f"{VIT_BWD_TOL:g} x max(1, max|plain|)"))
        # bytes: q, k, v, o, dO, lse, dprobs read once, dq, dk, dv written
        # once; operations per (row, key, head): the five products Q.K^T,
        # dO.V^T, P^T.dO, dS^T.Q and dS.K (2 Dh each), all fp32
        n_bytes = 4 * (8 * q.numel() + 2 * B * H * N)
        bnd, by = bound_ms(n_bytes, 10 * Dh * pairs)
        leaves_h = [t.clone().requires_grad_(True) for t in (qh, kh, vh)]

        def sdpa(leaves_h=leaves_h, doh=doh):
            out = F.scaled_dot_product_attention(*leaves_h)
            return torch.autograd.grad(out, leaves_h, doh)

        ms, lib_ms = time_ms(bwd), time_ms(sdpa)
        print(f"vit attention backward ({label}, [{B}, {N}, {H}, {Dh}]): "
              f"{ms * 1e3:.2f} us a call, {ms / bnd:.2f}x its bound "
              f"({bnd * 1e3:.2f} us, {by}), {ms / lib_ms:.3f}x SDPA's fp32 "
              f"forward + backward ({lib_ms * 1e3:.2f} us)", flush=True)
        cases.append(dict(
            label=label, errs=errs, fn=bwd, ms=ms,
            plain_ms=time_ms(bwd_plain, samples=5, calls=3, warmup=1),
            library_fn=sdpa, library_ms=lib_ms, bound_ms=bnd,
            bound_by=by, shapes=shapes + " backward, with the CLS "
                                         "probabilities' gradient"))
    head = cases[0]
    return dict(
        name="flash_attention_bwd_f32", source="flash_attention_bwd.cu",
        errs=[e for c in cases for e in c["errs"]], fn=head["fn"],
        ms=head["ms"], plain_ms=head["plain_ms"],
        library_fn=head["library_fn"], library_ms=head["library_ms"],
        library_call="F.scaled_dot_product_attention forward + backward on "
                     "fp32 (timing only; no CLS-probability gradient)",
        bound_ms=head["bound_ms"], bound_by=head["bound_by"],
        shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cases),
        cases=cases)


def check_token_drop_training(torch, dev, fwd_check):
    """The hard TDM of Algorithm 1's training, through the functions
    ``TokenDrop`` calls, against the plain versions at ``VIT_TDM_CASES``
    on CLS-probability-like scores (each row sums to 1) and, at the
    headline, on tie-heavy scores (three positive levels):

    * ``token_drop_f32`` writing the kept indices (a case of
      ``fwd_check`` per shape): the output bitwise the serve's, the
      indices the plain version's;
    * ``token_drop_bwd_f32`` against ``token_drop_bwd_plain``: dz bitwise
      at CLS and the kept rows, dropped rows and dscores within
      ``TDM_BWD_TOL`` x max(1, max|plain|), dscores exactly 0 at CLS and
      the kept rows, two launches bitwise equal. No library call computes
      it.

    Returns the backward's check, one entry per case under ``cases``."""
    from repro_torch.core import token_pruning as TP
    from repro_torch.kernels import backend
    from repro_torch.kernels.token_drop import ops as TD
    g = torch.Generator().manual_seed(13)
    fwd_cases = _as_cases(fwd_check)
    cases = []
    for ci, (label, B, N, D, k) in enumerate(VIT_TDM_CASES):
        z = torch.randn((B, N, D), generator=g).to(dev)
        dy = torch.randn((B, k + 2, D), generator=g).to(dev)
        errs = []
        for ties in ((False, True) if ci == 0 else (False,)):
            # training's scores are softmax probabilities, never 0: the
            # tie-heavy ones take three positive levels
            s = (torch.randint(1, 4, (B, N), generator=g).float().to(dev) / 8
                 if ties else _tdm_scores(torch, dev, g, B, N, (N,) * B))
            tag = f"{label}, tie-heavy" if ties else label
            before = backend.launches()
            out, idx = TD._token_drop_cuda(z, s, k, True)
            serve = TD.token_drop(z, s, k)
            out_ref, idx_ref = TP.tdm(z, s, None, has_cls=True, k=k)
            torch.cuda.synchronize()
            require(backend.launches()["token_drop_f32"]
                    == before["token_drop_f32"] + 2,
                    f"token_drop_f32 ({tag}, indices) did not launch")
            require(torch.equal(out, serve),
                    f"token_drop_f32 ({tag}): the output with indices is not "
                    f"the serve's bit for bit")
            require(torch.equal(idx.long(), idx_ref),
                    f"token_drop_f32 ({tag}): kept indices differ from the "
                    f"plain version's")
            res = TD._token_drop_bwd_cuda(z, s, idx, out, dy)
            again = TD._token_drop_bwd_cuda(z, s, idx, out, dy)
            ref = TD.token_drop_bwd_plain(z, s, idx, out, dy)
            torch.cuda.synchronize()
            require(backend.launches()["token_drop_bwd_f32"]
                    == before["token_drop_bwd_f32"] + 2,
                    f"token_drop_bwd_f32 ({tag}) did not launch")
            require(all(torch.equal(a, b) for a, b in zip(res, again)),
                    f"token_drop_bwd_f32 ({tag}): two launches differ")
            (dz, ds), (dz_ref, ds_ref) = res, ref
            rows = torch.arange(B, device=dev)[:, None]
            kept = torch.cat([torch.zeros_like(idx[:, :1]), 1 + idx],
                             dim=1).long()
            require(torch.equal(dz[rows, kept], dz_ref[rows, kept]),
                    f"token_drop_bwd_f32 ({tag}): dz at CLS or a kept row "
                    f"is not dy's row bit for bit")
            require(bool((ds[rows, kept] == 0).all()),
                    f"token_drop_bwd_f32 ({tag}): dscores not 0 at CLS or a "
                    f"kept row")
            for name, a, r in (("dz", dz, dz_ref), ("dscores", ds, ds_ref)):
                require(bool(torch.isfinite(a).all()),
                        f"token_drop_bwd_f32 ({tag}): {name} not finite")
                errs.append((f"{name} ({tag})", (a - r).abs().max().item(),
                             TDM_BWD_TOL * max(1.0, r.abs().max().item()),
                             f"{TDM_BWD_TOL:g} x max(1, max|plain|); CLS and "
                             f"kept rows bitwise"))
            if not ties:
                def fwd(z=z, s=s, k=k):
                    return TD._token_drop_cuda(z, s, k, True)

                def fwd_plain(z=z, s=s, k=k):
                    return TP.tdm(z, s, None, has_cls=True, k=k)

                fbnd, fby = bound_ms(4 * (z.numel() + s.numel()
                                          + B * (k + 2) * D + B * k),
                                     2 * B * (N - 1) * D)
                fwd_cases.append(dict(
                    label=f"train {label}, with indices", fn=fwd,
                    ms=time_ms(fwd), plain_ms=time_ms(fwd_plain),
                    library_fn=None, library_ms=None, bound_ms=fbnd,
                    bound_by=fby,
                    errs=[(f"fused row (train {label})",
                           (out[:, k + 1] - out_ref[:, k + 1]).abs().max()
                           .item(), 1e-5, "kept rows bitwise")],
                    shapes=f"z[{B},{N},{D}] k={k} (+kept indices; output "
                           f"bitwise the serve's)"))
                fwd_check["errs"].extend(fwd_cases[-1]["errs"])
                args = (z, s, idx, out, dy)
        n_drop = B * (N - 1 - k)
        # bytes: the dropped rows of z, dy, the fused rows of y, the scores
        # and the indices read once; dz and dscores written once
        n_bytes = 4 * (n_drop * D + dy.numel() + B * D + B * N + B * k
                       + z.numel() + B * N)
        bnd, by = bound_ms(n_bytes, 3 * n_drop * D)

        def bwd(args=args):
            return TD._token_drop_bwd_cuda(*args)

        def bwd_plain(args=args):
            return TD.token_drop_bwd_plain(*args)

        cases.append(dict(
            label=label, errs=errs, fn=bwd, ms=time_ms(bwd),
            plain_ms=time_ms(bwd_plain), library_fn=None, library_ms=None,
            bound_ms=bnd, bound_by=by,
            shapes=f"z[{B},{N},{D}] k={k} backward"
                   + (", random and tie-heavy scores" if ci == 0 else "")))
    head = cases[0]
    return dict(
        name="token_drop_bwd_f32", source="token_drop.cu",
        errs=[e for c in cases for e in c["errs"]], fn=head["fn"],
        ms=head["ms"], plain_ms=head["plain_ms"], library_fn=None,
        library_ms=None, library_call=None, bound_ms=head["bound_ms"],
        bound_by=head["bound_by"],
        shapes="; ".join(f"{c['label']}: {c['shapes']}" for c in cases),
        cases=cases)


# ---------------------------------------------------------------------------
# Phase 6a: LM training at full width and depth
# ---------------------------------------------------------------------------
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 8, 512
LM_TRAIN_STEPS = 8  # step 0 (warm-up), then 7 timed; then 1 profiled
# AdamW at launch/train's default rate (the reference launcher's): in an lr
# sweep of 8 steps from seed 0 (tools/lm_train_probe.py) it moved the loss
# the most of 1e-4, 3e-4 and 1e-3
LM_TRAIN_LR = 1e-3
# Step 0 on the card (bf16 activations, the kernels) against the CPU (fp32,
# plain attention) at full width cut to 2 layers, batch 2, seq 128: bf16
# rounds every activation to 2^-9 relative, which moves the loss by ~1e-5
# relative and each gradient leaf by ~1.5% of its largest element (1.43%
# and 6e-6 measured on an NVIDIA H100 80GB HBM3 at 700 W; 1.6% between
# bf16 and fp32 on the CPU alone). Bounds: the loss within 1e-3 relative,
# each leaf within 5% of its largest |CPU| element.
LM_TRAIN_LOSS_TOL = 1e-3
LM_TRAIN_GRAD_TOL = 0.05
# The loss after the 8 steps and the backward's device ms per step as the
# earlier three-kernel mma.sync backward gave them on an NVIDIA H100 80GB
# HBM3 at 700 W (the loss identical in three runs), printed beside this
# run's. Not a gate: 8 AdamW steps from random weights amplify last-bit
# differences, so a backward that rounds its sums in another order lands
# elsewhere (that backward with its two P.V halves added in the other
# order ended at 109.6644 and strayed 1.4e-3 relative at step 6,
# tools/lm_train_probe.py); one-ulp gradients and step 0 against the CPU
# are the gates.
LM_TRAIN_LOSS_REF = 109.6294
LM_TRAIN_BWD_REF_MS = 8.30
# The same 8 steps' loss and the phase's peak device memory with the
# functional AdamW update (``AdamW.update``) on an NVIDIA H100 80GB HBM3 at
# 700 W (the loss identical in two runs); the in-place update
# (``AdamW.update_``) does the same arithmetic, so the loss must not move,
# and the peak falls by the moments and temporaries it no longer makes
LM_TRAIN_LOSS_FUNCTIONAL = 109.4796
LM_TRAIN_PEAK_FUNCTIONAL_GIB = 58.82


@contextlib.contextmanager
def count_plain(*names):
    """Count calls of the plain versions named by (module, attribute)
    pairs while the block runs (none may run on the card): yields the
    counts by attribute name."""
    calls = {name: 0 for _, name in names}
    inner = [getattr(mod, name) for mod, name in names]

    def counted(name, fn):
        def call(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return call
    for (mod, name), fn in zip(names, inner):
        setattr(mod, name, counted(name, fn))
    try:
        yield calls
    finally:
        for (mod, name), fn in zip(names, inner):
            setattr(mod, name, fn)


def train_parts(rows, busy_us, label):
    """Print one profiled LM training step's device time by kernel group
    (each kernel in the first group its name matches) and its largest
    kernels; returns {group: [launches, device us]}."""
    groups = {"attention forward (flash_prefill_bf16)":
              lambda n: kernel_symbol("flash_prefill_bf16") in n,
              "attention backward (flash_prefill_bwd_bf16)":
              lambda n: kernel_symbol("flash_prefill_bwd_bf16") in n,
              "non-causal attention forward "
              "(flash_prefill_bf16/noncausal)":
              lambda n: kernel_symbol("flash_prefill_bf16/noncausal") in n,
              "non-causal attention backward "
              "(flash_prefill_bwd_bf16/noncausal)":
              lambda n: kernel_symbol("flash_prefill_bwd_bf16/noncausal")
              in n,
              "GEMMs (cuBLAS)": lambda n: "nvjet" in n
              or "gemm" in n.lower() or "xmma" in n,
              "AdamW (multi_tensor_apply)": lambda n: "multi_tensor" in n,
              "casts and copies": lambda n: "copy" in n,
              "reductions (norms, softmax, sums)": lambda n: "reduce" in n
              or "softmax" in n.lower() or "norm" in n.lower()}
    split = {k: [0, 0.0] for k in [*groups, "other elementwise"]}
    for n, k, us in rows:
        key = next((g for g, f in groups.items() if f(n)),
                   "other elementwise")
        split[key][0] += k
        split[key][1] += us
    print(f"profile {label} step by part: " + "; ".join(
        f"{g} {us / 1e3:.2f} ms ({k} launches, {us / busy_us:.3f})"
        for g, (k, us) in split.items()), flush=True)
    for n, k, us in rows[:12]:
        print(f"  device {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)
    return split


def lm_step0_card_vs_cpu(torch, dev, cfg, layers=2, prune=True, gate=None):
    """Step 0's loss and gradients (``models/steps.make_grad_fn``, with
    pruning unless ``prune`` is False) of ``cfg`` cut to ``layers`` layers,
    batch 2, seq 128 (with the VLM's or the audio family's modality input
    from ``synthetic_lm_batch``; the VLM's cross gates at ``gate`` if
    given), from ``launch/train.make_state_factory``'s seeds: on the card
    (``cfg``'s dtype, the kernels) and on the CPU (fp32, plain attention).
    Returns the card's loss, the CPU's, the CPU's seconds, the card's kernel
    launches (non-causal forms included) and, per gradient leaf,
    ``(max|card - CPU| / max|CPU|, max|card - CPU|, max|CPU|, path)``,
    worst first."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.launch import train as LT
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import flatten_with_path, path_str, tree_map

    small = cfg.replace(num_layers=layers)
    st = LT.make_state_factory(small, AdamW(), dev, with_scores=prune)()
    if gate is not None:
        for c in st["params"]["stages"]["cross"]:
            c["gate"].fill_(gate)
    host = {k: torch.from_numpy(v) for k, v in synthetic_lm_batch(
        small, ShapeConfig("t", 128, 2, "train"), DataConfig(), 0).items()}
    backend.reset_launches()
    loss_c, _, g_c = ST.make_grad_fn(small, prune)(
        st["params"], {k: v.to(dev) for k, v in host.items()}, st["scores"])
    launches = {k: v for k, v in {**backend.launches(),
                                  **backend.form_launches()}.items() if v}
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    loss_h, _, g_h = ST.make_grad_fn(small.replace(dtype="float32"), prune)(
        tree_map(lambda t: t.to(cpu), st["params"]), host,
        tree_map(lambda t: t.to(cpu), st["scores"]))
    cpu_s = time.perf_counter() - t0
    rows = []
    for (path, a), (_, b) in zip(flatten_with_path(g_c),
                                 flatten_with_path(g_h)):
        d = (a.cpu().float() - b).abs().max().item()
        m = b.abs().max().item()
        # a leaf the loss does not reach (the cross layers' bk / bv) is
        # exactly 0 on both sides
        rows.append((d / m if m else 0.0 if d == 0 else float("inf"), d, m,
                     path_str(path)))
    rows.sort(reverse=True)
    del st, g_c, g_h
    torch.cuda.empty_cache()
    return loss_c.item(), loss_h.item(), cpu_s, launches, rows


def lm_train_path(torch, dev):
    """LM training (``models/steps.make_train_step``) of full-width
    StableLM-1.6B (24 layers, D=2048, 32 heads, Dh 64, vocab 100352;
    params from seed 0 drawn on the card, scores from seed 7 by
    ``launch/train.make_state_factory``) with ``launch/train``'s
    ``--prune`` config, batches of 8 x 512 tokens from
    ``synthetic_lm_batch`` by step, AdamW at ``LM_TRAIN_LR``. Gates: (a)
    the loss falls; (b) step 0 on the card against the CPU at 2 layers
    (``LM_TRAIN_*_TOL``); (c) per step, ``flash_prefill_bf16`` launched 2
    x 24 times (forward and full-remat recompute) and
    ``flash_prefill_bwd_bf16`` 24 times, no other kernel entry point and
    no plain attention; (d) TF32 off. Returns the last step's launch
    counts."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import STABLELM_1_6B
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train as LT
    from repro_torch.models import attention as A
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "lm train: fp32 matmuls must not run on TF32")
    cfg = LT.prune_config(STABLELM_1_6B)
    L = cfg.num_layers

    # (b) step 0 at 2 layers on the card and on the CPU
    loss_c, loss_h, cpu_s, _, rows = lm_step0_card_vs_cpu(torch, dev, cfg)
    err_loss = abs(loss_c - loss_h) / abs(loss_h)
    print(f"lm train step 0 at 2 layers, batch 2, seq 128, card (bf16, "
          f"kernels) vs CPU (fp32, plain; {cpu_s:.1f} s): loss "
          f"{loss_c:.6f} vs {loss_h:.6f} (rel {err_loss:.3g}, "
          f"tolerance {LM_TRAIN_LOSS_TOL:g}); gradients, worst "
          f"max|d| / max|CPU| per leaf of {len(rows)}: "
          + ", ".join(f"{r:.4g} ({p})" for r, _, _, p in rows[:3])
          + f" (tolerance {LM_TRAIN_GRAD_TOL:g})", flush=True)
    require(err_loss <= LM_TRAIN_LOSS_TOL,
            f"lm train step 0: loss card vs CPU rel {err_loss:.3g}")
    require(rows[0][0] <= LM_TRAIN_GRAD_TOL,
            f"lm train step 0: gradients card vs CPU, worst {rows[:3]}")

    opt = AdamW(lr=LM_TRAIN_LR, weight_decay=0.01)
    t0 = time.perf_counter()
    state = LT.make_state_factory(cfg, opt, dev, with_scores=True)()
    params, scores, opt_state = state["params"], state["scores"], state["opt"]
    del state  # a step's old state is freed as the next is made
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    step = ST.make_train_step(cfg, opt, with_pruning=True)
    shape = ShapeConfig("t", LM_TRAIN_SEQ, LM_TRAIN_BATCH, "train")
    host = [synthetic_lm_batch(cfg, shape, DataConfig(), i)["tokens"]
            for i in range(LM_TRAIN_STEPS + 1)]
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    print(f"lm train: {cfg.name} at full width and depth ({L} layers, "
          f"D={cfg.d_model}, {cfg.num_heads} heads, Dh={cfg.head_dim}, vocab "
          f"{cfg.vocab_size}), {n_params / 1e9:.4f} B params and "
          f"{sum(t.numel() for t in scores.values()) / 1e6:.3f} M scores "
          f"(block {cfg.pruning.block_size}, r_b {cfg.pruning.r_b}), fp32 "
          f"with AdamW state, made in {time.perf_counter() - t0:.2f} s; "
          f"batch {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ} tokens, bf16 "
          f"activations, remat {cfg.remat_policy}, lr {LM_TRAIN_LR:g}",
          flush=True)

    def one(i):
        toks = torch.from_numpy(host[i]).to(dev)
        return step(params, opt_state, {"tokens": toks}, scores)

    metrics, walls, counts = [], [], []
    with count_plain((FA, "attention_causal_plain"),
                     (A, "flash_attention_torch")) as plain_calls:
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(LM_TRAIN_STEPS):
            torch.cuda.synchronize()
            backend.reset_launches()
            t0 = time.perf_counter()
            params, scores, opt_state, m = one(i)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            counts.append(backend.launches())
            metrics.append({k: v.item() for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            params, scores, opt_state, m = one(LM_TRAIN_STEPS)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
    require(not any(plain_calls.values()),
            f"lm train: the plain attention ran on the card: {plain_calls}")
    want = {"flash_prefill_bf16": 2 * L, "flash_prefill_bwd_bf16": L}
    for i, n in enumerate(counts):
        got = {k: v for k, v in n.items() if v}
        require(got == want, f"lm train step {i}: launches {got}, want "
                             f"{want}")
    losses = [m["loss"] for m in metrics]
    ces = [m["ce"] for m in metrics]
    require(all(math.isfinite(x) for x in losses + ces),
            f"lm train: a loss is not finite: {losses}")
    require(losses[-1] < losses[0], f"lm train: loss did not fall: {losses}")
    wall = statistics.median(walls[1:])
    print(f"lm train: losses {[round(x, 4) for x in losses]} (ce "
          f"{[round(x, 4) for x in ces]}; the rest is lambda_reg x the "
          f"scores' sparsity term); launches per step {want}, plain "
          f"attention calls 0", flush=True)
    print(f"lm train: wall per step median {wall * 1e3:.2f} ms over "
          f"{len(walls) - 1} steps after step 0 (min "
          f"{min(walls[1:]) * 1e3:.2f}, max {max(walls[1:]) * 1e3:.2f}; step "
          f"0 {walls[0] * 1e3:.1f} ms; the batch copied in the step): "
          f"{tokens / wall:.1f} training tokens/s; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB (the functional update's "
          f"{LM_TRAIN_PEAK_FUNCTIONAL_GIB} GiB)", flush=True)
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows)
    print(f"profile lm train step ({sum(r[1] for r in rows)} device "
          f"launches): wall {dt * 1e6:.0f} us profiled / {wall * 1e6:.0f} us "
          f"unprofiled median, device busy {busy_us:.0f} us, idle share "
          f"{1.0 - busy_us / (dt * 1e6):.3f} profiled / "
          f"{1.0 - busy_us / (wall * 1e6):.3f} unprofiled", flush=True)
    split = train_parts(rows, busy_us, "lm train")
    bwd_k, bwd_us = split["attention backward (flash_prefill_bwd_bf16)"]
    err_ref = abs(losses[-1] - LM_TRAIN_LOSS_REF) / LM_TRAIN_LOSS_REF
    print(f"lm train: attention backward {bwd_us / 1e3:.2f} ms on the card "
          f"per step in {bwd_k} kernels ({LM_TRAIN_BWD_REF_MS:.2f} ms for the "
          f"three-kernel mma.sync backward); loss after {LM_TRAIN_STEPS} "
          f"steps {losses[-1]:.4f} against {LM_TRAIN_LOSS_REF} (rel "
          f"{err_ref:.3g}; printed, not gated) and the functional AdamW "
          f"update's {LM_TRAIN_LOSS_FUNCTIONAL} (equal: "
          f"{round(losses[-1], 4) == LM_TRAIN_LOSS_FUNCTIONAL})", flush=True)
    del params, scores, opt_state, m, prof
    torch.cuda.empty_cache()
    return counts[-1]


# ---------------------------------------------------------------------------
# Phase 6c: training the hybrid and SSM families, full-width Zamba2-1.2B
# and RWKV6-1.6B
# ---------------------------------------------------------------------------
SSM_TRAIN_BATCH, SSM_TRAIN_SEQ = 8, 512
SSM_TRAIN_STEPS = 8  # step 0 (warm-up), then 7 timed; then 1 profiled
# Step 0 card (bf16, kernels) vs CPU (fp32, plain), by model: (layers,
# attn_layer_period or None for the config's), under the dense LM's gates
# (the loss within LM_TRAIN_LOSS_TOL, each gradient leaf within
# LM_TRAIN_GRAD_TOL of its largest CPU element). Random-init Zamba2 is
# chaotic in bf16 past its first layer, in the reference as in the port:
# the reference's own bf16 gradients lie 0.026 x a leaf's largest element
# from its fp32 ones at 1 layer of period 1, 0.17 at 2, 2.11 at 7
# (tools/step0_reference_witness.py, on the CPU, full width), so no bf16
# run can meet the gate deeper. Zamba2 runs at 1 layer of period 1: a
# Mamba2 layer, then the shared attention block, each trained through its
# kernels. RWKV6 at 2 layers.
SSM_TRAIN_STEP0 = {"zamba2-1.2b": (1, 1), "rwkv6-1.6b": (2, None)}


def ssm_train_launches(cfg):
    """Kernel launches of one training step of ``cfg``: a scan forward and
    backward per recurrent layer (RWKV6's forward twice: its layers are
    recomputed under full remat; the hybrid's are not checkpointed, as in
    the reference) and the causal pair once per shared-block call."""
    if cfg.family == "ssm":
        return {"wkv6_f32": 2 * cfg.num_layers,
                "wkv6_bwd_f32": cfg.num_layers}
    from repro_torch.models import model as M
    n_stages = M.hybrid_layout(cfg)[1]
    return {"mamba_scan_f32": cfg.num_layers,
            "mamba_scan_bwd_f32": cfg.num_layers,
            "flash_prefill_bf16": n_stages,
            "flash_prefill_bwd_bf16": n_stages}


def ssm_train_path(torch, dev):
    """Training (``models/steps.make_train_step``, ``launch/train``'s
    ``--prune`` config) of full-width Zamba2-1.2B (38 Mamba2 layers, a
    shared attention block after every 6) and RWKV6-1.6B (24 layers),
    params from seed 0 on the card, scores from seed 7, batches of 8 x 512
    from ``synthetic_lm_batch`` by step, AdamW at ``LM_TRAIN_LR``. Gates,
    per model: (a) step 0 on the card against the CPU at the cuts of
    ``SSM_TRAIN_STEP0`` (the dense LM's: loss within 1e-3, each gradient
    leaf within 5% of its largest; the cut's ``ssm_train_launches``);
    (b) every step's loss finite; (c) per step, exactly
    ``ssm_train_launches`` and no plain scan, scan backward or attention
    on the card. Returns {"<model>
    train": the last step's launch counts}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import RWKV6_1_6B, ZAMBA2_1_2B
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.ssm_scan import ops as SS
    from repro_torch.launch import train as LT
    from repro_torch.models import attention as A
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    out = {}
    for base in (ZAMBA2_1_2B, RWKV6_1_6B):
        cfg = LT.prune_config(base)
        tag = f"{cfg.name} train"
        cut, period = SSM_TRAIN_STEP0[cfg.name]
        c = cfg if period is None else cfg.replace(attn_layer_period=period)
        loss_c, loss_h, cpu_s, l0, rows = lm_step0_card_vs_cpu(
            torch, dev, c, layers=cut)
        err_loss = abs(loss_c - loss_h) / abs(loss_h)
        at = f"{cut} layers" + ("" if period is None else
                                f" of period {period}")
        print(f"{tag} step 0 at {at}, batch 2, seq 128, card (bf16, "
              f"kernels: {l0}) vs CPU (fp32, plain; {cpu_s:.1f} s): loss "
              f"{loss_c:.6f} vs {loss_h:.6f} (rel {err_loss:.3g}, tolerance "
              f"{LM_TRAIN_LOSS_TOL:g}); gradients, worst max|d| / max|CPU| "
              f"per leaf of {len(rows)}: "
              + ", ".join(f"{r:.4g} ({p})" for r, _, _, p in rows[:3])
              + f" (tolerance {LM_TRAIN_GRAD_TOL:g})", flush=True)
        require(err_loss <= LM_TRAIN_LOSS_TOL,
                f"{tag} step 0 at {at}: loss card vs CPU rel {err_loss:.3g}")
        require(rows[0][0] <= LM_TRAIN_GRAD_TOL,
                f"{tag} step 0 at {at}: gradients card vs CPU, worst "
                f"{rows[:3]}")
        want = ssm_train_launches(c.replace(num_layers=cut))
        require(l0 == want, f"{tag} step 0 at {at}: launches {l0}, want "
                            f"{want}")

        opt = AdamW(lr=LM_TRAIN_LR, weight_decay=0.01)
        t0 = time.perf_counter()
        state = LT.make_state_factory(cfg, opt, dev, with_scores=True)()
        params, scores, opt_state = (state["params"], state["scores"],
                                     state["opt"])
        del state
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in leaves(params))
        step = ST.make_train_step(cfg, opt, with_pruning=True)
        shape = ShapeConfig("t", SSM_TRAIN_SEQ, SSM_TRAIN_BATCH, "train")
        host = [synthetic_lm_batch(cfg, shape, DataConfig(), i)["tokens"]
                for i in range(SSM_TRAIN_STEPS + 1)]
        tokens = SSM_TRAIN_BATCH * SSM_TRAIN_SEQ
        print(f"{tag}: {cfg.name} at full width and depth ({cfg.family}, "
              f"{cfg.num_layers} layers, D={cfg.d_model}, vocab "
              f"{cfg.vocab_size}), {n_params / 1e9:.4f} B params and "
              f"{sum(t.numel() for t in scores.values()) / 1e6:.3f} M scores "
              f"(block {cfg.pruning.block_size}, r_b {cfg.pruning.r_b}: "
              f"{sorted({k.split('/')[-1] for k in scores})}), fp32 with "
              f"AdamW state, made in {time.perf_counter() - t0:.2f} s; batch "
              f"{SSM_TRAIN_BATCH} x {SSM_TRAIN_SEQ} tokens, bf16 "
              f"activations, remat "
              f"{cfg.remat_policy if cfg.family == 'ssm' else 'none'}, lr "
              f"{LM_TRAIN_LR:g}", flush=True)

        def one(i):
            toks = torch.from_numpy(host[i]).to(dev)
            return step(params, opt_state, {"tokens": toks}, scores)

        metrics, walls, counts = [], [], []
        with count_plain((SS, "mamba_scan_plain"), (SS, "wkv6_plain"),
                         (SS, "mamba_scan_bwd_plain"),
                         (SS, "wkv6_bwd_plain"),
                         (FA, "attention_causal_plain"),
                         (A, "flash_attention_torch")) as plain_calls:
            torch.cuda.reset_peak_memory_stats(dev)
            for i in range(SSM_TRAIN_STEPS):
                torch.cuda.synchronize()
                backend.reset_launches()
                t0 = time.perf_counter()
                params, scores, opt_state, m = one(i)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts.append(backend.launches())
                metrics.append({k: v.item() for k, v in m.items()})
            peak = torch.cuda.max_memory_allocated(dev)
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, scores, opt_state, m = one(SSM_TRAIN_STEPS)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
        require(not any(plain_calls.values()),
                f"{tag}: a plain version ran on the card: {plain_calls}")
        want = ssm_train_launches(cfg)
        for i, n in enumerate(counts):
            got = {k: v for k, v in n.items() if v}
            require(got == want, f"{tag} step {i}: launches {got}, want "
                                 f"{want}")
        losses = [m["loss"] for m in metrics]
        require(all(math.isfinite(x) for x in losses),
                f"{tag}: a loss is not finite: {losses}")
        wall = statistics.median(walls[1:])
        print(f"{tag}: losses {[round(x, 4) for x in losses]} (step 0 "
              f"{losses[0]:.4f}; the rest of each is lambda_reg x the "
              f"scores' sparsity term); launches per step {want}, plain "
              f"calls on the card 0", flush=True)
        print(f"{tag}: wall per step median {wall * 1e3:.2f} ms over "
              f"{len(walls) - 1} steps after step 0 (min "
              f"{min(walls[1:]) * 1e3:.2f}, max {max(walls[1:]) * 1e3:.2f}; "
              f"step 0 {walls[0] * 1e3:.1f} ms): {tokens / wall:.1f} "
              f"training tokens/s; peak device memory "
              f"{peak / 2 ** 30:.2f} GiB", flush=True)
        prof_rows = _device_rows(prof)
        busy_us = sum(r[2] for r in prof_rows)
        print(f"profile {tag} step ({sum(r[1] for r in prof_rows)} device "
              f"launches): wall {dt * 1e6:.0f} us profiled / "
              f"{wall * 1e6:.0f} us unprofiled median, device busy "
              f"{busy_us:.0f} us, idle share {1.0 - busy_us / (dt * 1e6):.3f}"
              f" profiled / {1.0 - busy_us / (wall * 1e6):.3f} unprofiled",
              flush=True)
        train_parts(prof_rows, busy_us, tag)
        for entry in want:
            sym = kernel_symbol(entry)
            k = sum(r[1] for r in prof_rows if sym in r[0])
            us = sum(r[2] for r in prof_rows if sym in r[0])
            print(f"{tag}: {entry} {us / 1e3:.3f} ms of device time per step"
                  f" in {k} kernels ({us / busy_us:.3f} of busy)", flush=True)
        out[tag] = counts[-1]
        del params, scores, opt_state, m, prof, step
        torch.cuda.empty_cache()
    print(f"ssm train: phase wall {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 6d: training the VLM and audio families, full-width Whisper-base and
# Llama-3.2-Vision-90B at cut depth
# ---------------------------------------------------------------------------
MM_TRAIN_STEPS = 8  # step 0 (warm-up), then 7 timed; then 1 profiled
MM_TRAIN_SEQ = 512  # Whisper: 64 decoder tokens over 1500 frames a row
# batch rows, the first whose step fits the card: Whisper-base takes 8;
# Llama-3.2-Vision-90B's 3.81 B params hold ~57 GiB of fp32 training state
MM_TRAIN_BATCHES = (8, 4, 2)
MM_TRAIN_STEP0_LAYERS = 2  # the step-0 cut (Whisper's encoder cut alike)


def mm_train_launches(cfg):
    """Attention launches of one training step of ``cfg`` (full remat), by
    entry point and form (``backend.FORMS``; a form's launches count under
    its entry point too): the VLM recomputes each stage, so each of its
    causal self-attention layers and gated cross layers runs its forward
    twice and its backward once; Whisper's decoder layers alike (causal
    self-attention, non-causal cross-attention), its encoder's non-causal
    self-attention (not checkpointed) once each way."""
    from repro_torch.models import model as M
    if cfg.family == "vlm":
        n_stages, n_self = M.vlm_layout(cfg)
        causal, cross, enc = n_stages * n_self, n_stages, 0
    else:
        causal = cross = cfg.num_layers
        enc = cfg.encoder_layers
    return {"flash_prefill_bf16": 2 * (causal + cross) + enc,
            "flash_prefill_bwd_bf16": causal + cross + enc,
            "flash_prefill_bf16/noncausal": 2 * cross + enc,
            "flash_prefill_bwd_bf16/noncausal": cross + enc}


def mm_train_path(torch, dev):
    """Training (``models/steps.make_train_step``, no pruning: neither
    family's config has any) of full-width Whisper-base (6 encoder and 6
    decoder layers, D 512, 8 heads of Dh 64, biases) and of
    Llama-3.2-Vision-90B at full width (D 8192, 64 query over 8 KV heads of
    Dh 128, d_ff 28,672, vocab 128,256, 1601 vision tokens) cut as
    ``launch/train --full`` cuts it (``train_config``: 2 layers of
    ``cross_attn_period`` 2, one self-attention layer and one gated cross
    layer: 3.81 B params; one stage of the real period would hold ~102 GB
    of fp32 training state), params from seed 0 drawn on the card,
    every cross gate ``MM_GATE``, batches of ``synthetic_lm_batch`` by step
    at seq 512 (Whisper's: 64 tokens over 1500 frames a row), the VLM at
    the first of ``MM_TRAIN_BATCHES`` rows whose step fits, AdamW at
    ``LM_TRAIN_LR``. Gates, per model: (a) step 0 on the card (bf16, the
    kernels) against the CPU (fp32, plain) at ``MM_TRAIN_STEP0_LAYERS``
    layers, batch 2, seq 128 (the dense LM's: loss within 1e-3, each
    gradient leaf within 5% of its largest) with the cut's
    ``mm_train_launches``; (b) every loss finite; (c) per step exactly
    ``mm_train_launches`` and no plain attention on the card. Prints the
    losses, wall per step, tokens/s, peak memory, the profiled step's busy
    and idle share, device time by part and per kernel form. Returns
    {"<model> train": the last step's launch counts, forms included}."""
    import gc
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import LLAMA_3_2_VISION_90B, WHISPER_BASE
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train as LT
    from repro_torch.models import attention as A
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    full_v = LLAMA_3_2_VISION_90B
    # the configs ``launch/train --full`` trains: Whisper-base uncut, the
    # VLM cut by ``LT.CARD_CUTS``
    whisper, vision = (LT.train_config(c.name, reduced=False)
                       for c in (WHISPER_BASE, full_v))
    out = {}
    for tag, cfg, small in (
            ("whisper train", whisper, whisper.replace(
                encoder_layers=MM_TRAIN_STEP0_LAYERS)),
            ("vision train", vision, vision)):
        vlm = cfg.family == "vlm"
        gate = MM_GATE if vlm else None
        if vlm:
            print(f"{tag}: reduced: {cfg.num_layers} of {full_v.num_layers} "
                  f"layers (launch/train's CARD_CUTS), cross_attn_period "
                  f"{cfg.cross_attn_period} (the reference's reduced "
                  f"period) of {full_v.cross_attn_period}: one "
                  f"self-attention layer and one gated cross layer at full "
                  f"width; every cross gate {MM_GATE} (tanh "
                  f"{math.tanh(MM_GATE):.4f})", flush=True)
        loss_c, loss_h, cpu_s, l0, rows = lm_step0_card_vs_cpu(
            torch, dev, small, layers=MM_TRAIN_STEP0_LAYERS, prune=False,
            gate=gate)
        err_loss = abs(loss_c - loss_h) / abs(loss_h)
        at = f"{MM_TRAIN_STEP0_LAYERS} layers" + (
            "" if vlm else f" and {MM_TRAIN_STEP0_LAYERS} encoder layers")
        print(f"{tag} step 0 at {at}, batch 2, seq 128, card (bf16, "
              f"kernels: {l0}) vs CPU (fp32, plain; {cpu_s:.1f} s): loss "
              f"{loss_c:.6f} vs {loss_h:.6f} (rel {err_loss:.3g}, tolerance "
              f"{LM_TRAIN_LOSS_TOL:g}); gradients, worst max|d| / max|CPU| "
              f"per leaf of {len(rows)}: "
              + ", ".join(f"{r:.4g} ({p})" for r, _, _, p in rows[:3])
              + f" (tolerance {LM_TRAIN_GRAD_TOL:g})", flush=True)
        require(err_loss <= LM_TRAIN_LOSS_TOL,
                f"{tag} step 0 at {at}: loss card vs CPU rel {err_loss:.3g}")
        require(rows[0][0] <= LM_TRAIN_GRAD_TOL,
                f"{tag} step 0 at {at}: gradients card vs CPU, worst "
                f"{rows[:3]}")
        want = mm_train_launches(small.replace(
            num_layers=MM_TRAIN_STEP0_LAYERS))
        require(l0 == want, f"{tag} step 0 at {at}: launches {l0}, want "
                            f"{want}")

        opt = AdamW(lr=LM_TRAIN_LR, weight_decay=0.01)
        t0 = time.perf_counter()
        state = LT.make_state_factory(cfg, opt, dev)()
        params, opt_state = state["params"], state["opt"]
        del state
        if vlm:
            for c in params["stages"]["cross"]:
                c["gate"].fill_(MM_GATE)
        torch.cuda.synchronize()
        n_params = sum(t.numel() for t in leaves(params))
        step = ST.make_train_step(cfg, opt)
        print(f"{tag}: {cfg.name} ({cfg.family}, {cfg.num_layers} layers"
              + ("" if vlm else f" and {cfg.encoder_layers} encoder layers")
              + f", D={cfg.d_model}, {cfg.num_heads} query over "
              f"{cfg.num_kv_heads} KV heads of Dh {cfg.head_dim}, vocab "
              f"{cfg.vocab_size}), {n_params / 1e9:.4f} B params, fp32 with "
              f"AdamW state, made in {time.perf_counter() - t0:.2f} s; bf16 "
              f"activations, remat {cfg.remat_policy}, lr {LM_TRAIN_LR:g}",
              flush=True)

        def batch(B, i):
            """Step i's batch of B rows on the card (copied before the
            step's clock starts: loading data is set-up)."""
            host = synthetic_lm_batch(cfg, ShapeConfig(
                "t", MM_TRAIN_SEQ, B, "train"), DataConfig(), i)
            return {k: torch.from_numpy(v).to(dev) for k, v in host.items()}

        # the batch: the first of MM_TRAIN_BATCHES whose step 0 fits (a
        # step that runs out of memory stops before AdamW's in-place
        # update, so the state is as it was)
        for B in (MM_TRAIN_BATCHES if vlm else MM_TRAIN_BATCHES[:1]):
            b = batch(B, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            try:
                backend.reset_launches()
                t0 = time.perf_counter()
                params, _, opt_state, m0 = step(params, opt_state, b)
                torch.cuda.synchronize()
                wall0 = time.perf_counter() - t0
                break
            except torch.cuda.OutOfMemoryError:
                print(f"{tag}: batch {B} x {MM_TRAIN_SEQ} does not fit the "
                      f"card", flush=True)
            del b
            gc.collect()
            torch.cuda.empty_cache()
        else:
            require(False, f"{tag}: no batch of {MM_TRAIN_BATCHES} fits")
        n_tok = b["tokens"].numel()
        extra = ("vision_embeds" if vlm else "audio_frames")
        n_mod = b[extra].shape[1]
        counts = [{**backend.launches(), **backend.form_launches()}]
        metrics = [{k: v.item() for k, v in m0.items()}]
        walls = [wall0]
        del b, m0
        with count_plain((FA, "attention_causal_plain"),
                         (FA, "attention_noncausal_plain"),
                         (FA, "attention_plain"),
                         (A, "flash_attention_torch")) as plain_calls:
            for i in range(1, MM_TRAIN_STEPS):
                b = batch(B, i)
                torch.cuda.synchronize()
                backend.reset_launches()
                t0 = time.perf_counter()
                params, _, opt_state, m = step(params, opt_state, b)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                counts.append({**backend.launches(),
                               **backend.form_launches()})
                metrics.append({k: v.item() for k, v in m.items()})
                del b
            peak = torch.cuda.max_memory_allocated(dev)
            b = batch(B, MM_TRAIN_STEPS)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, _, opt_state, m = step(params, opt_state, b)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            del b
        require(not any(plain_calls.values()),
                f"{tag}: a plain attention ran on the card: {plain_calls}")
        want = mm_train_launches(cfg)
        for i, n in enumerate(counts):
            got = {k: v for k, v in n.items() if v}
            require(got == want, f"{tag} step {i}: launches {got}, want "
                                 f"{want}")
        losses = [x["loss"] for x in metrics]
        require(all(math.isfinite(x) for x in losses),
                f"{tag}: a loss is not finite: {losses}")
        wall = statistics.median(walls[1:])
        print(f"{tag}: batch {B} x {MM_TRAIN_SEQ} ({n_tok // B} tokens a "
              f"row against {n_mod} "
              f"{'vision tokens' if vlm else 'audio frames'}); losses "
              f"{[round(x, 4) for x in losses]}; launches per step "
              f"{want}, plain attention calls on the card 0", flush=True)
        print(f"{tag}: wall per step median {wall * 1e3:.2f} ms over "
              f"{len(walls) - 1} steps after step 0 (min "
              f"{min(walls[1:]) * 1e3:.2f}, max {max(walls[1:]) * 1e3:.2f}; "
              f"step 0 {walls[0] * 1e3:.1f} ms; the batch on the card "
              f"beforehand): {n_tok / wall:.1f} training tokens/s "
              f"({B * n_mod / wall:.1f} "
              f"{'vision tokens' if vlm else 'audio frames'}/s); peak "
              f"device memory {peak / 2 ** 30:.2f} GiB of the card's "
              f"{torch.cuda.get_device_properties(dev).total_memory / 2 ** 30:.2f}"
              f" GiB", flush=True)
        prof_rows = _device_rows(prof)
        busy_us = sum(r[2] for r in prof_rows)
        print(f"profile {tag} step ({sum(r[1] for r in prof_rows)} device "
              f"launches): wall {dt * 1e6:.0f} us profiled / "
              f"{wall * 1e6:.0f} us unprofiled median, device busy "
              f"{busy_us:.0f} us, idle share {1.0 - busy_us / (dt * 1e6):.3f}"
              f" profiled / {1.0 - busy_us / (wall * 1e6):.3f} unprofiled",
              flush=True)
        train_parts(prof_rows, busy_us, tag)
        for entry in want:
            sym = kernel_symbol(entry)
            k = sum(r[1] for r in prof_rows if sym in r[0])
            us = sum(r[2] for r in prof_rows if sym in r[0])
            print(f"{tag}: {entry} {us / 1e3:.3f} ms of device time per step"
                  f" in {k} kernels ({us / busy_us:.3f} of busy)", flush=True)
        out[tag] = counts[-1]
        del params, opt_state, m, prof, step
        gc.collect()
        torch.cuda.empty_cache()
    print(f"mm train: phase wall {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# Phase 4c2: the paper's TDM on Minitron-4B's prompts (models/prefill_prune)
# ---------------------------------------------------------------------------
PREFILL_TDM_B, PREFILL_TDM_N = 4, 500   # prompts x tokens
PREFILL_TDM_RT, PREFILL_TDM_LAYERS = 0.7, (2, 6, 9)  # the DeiT config's
PREFILL_TDM_FINAL = 175  # 500 -> 352 -> 248 -> 175 tokens
PREFILL_TDM_REPEATS = 3  # timed prefills of each kind, in turns
PREFILL_TDM_ORACLE_LAYERS = 12  # of 32, one prompt, card vs CPU fp32
# a kept set may differ between the card (bf16) and the CPU (fp32) only at
# tokens whose CPU score lies within this share of the CPU's k-th largest
# (bf16 rounds q and k to 2^-9, which moves a probability by a few percent)
PREFILL_TDM_NEAR_TIE = 0.05


@contextlib.contextmanager
def record_drops(torch, replay=None):
    """Record each TDM layer's kept indices (``token_pruning
    .drop_weights``, as ``prefill_prune`` calls it) with its body scores;
    with ``replay`` (a list of kept indices), keep those instead, the
    weights computed from this run's scores. Yields the records."""
    from repro_torch.core import token_pruning as TP
    inner, seen = TP.drop_weights, []
    it = None if replay is None else iter(replay)

    def drop_weights(s_body, k):
        if it is None:
            top, w = inner(s_body, k)
        else:
            top = next(it).to(s_body.device)
            keep = torch.zeros(s_body.shape, dtype=torch.bool,
                               device=s_body.device).scatter_(1, top, True)
            w = torch.where(keep, 0.0, s_body.float())
            w = w / (w.sum(dim=1, keepdim=True) + 1e-9)
        seen.append((top.cpu(), s_body.float().cpu()))
        return top, w
    TP.drop_weights = drop_weights
    try:
        yield seen
    finally:
        TP.drop_weights = inner


def prefill_tdm_path(torch, dev, cfg, params):
    """``prefill_prune.pruned_prefill_logits`` on the uncut Minitron-4B of
    ``lm_path`` (its bf16 serving copy): ``PREFILL_TDM_B`` prompts of
    ``PREFILL_TDM_N`` tokens, r_t ``PREFILL_TDM_RT`` at
    ``PREFILL_TDM_LAYERS``, against the dense prefill of the same prompts
    (the same function at r_t 1). Gates: ``PREFILL_TDM_FINAL`` tokens
    left; finite logits; per prefill the causal prefill kernel once per
    layer and the decode kernel once per TDM layer (the score row), the
    dense prefill no decode launch; the oracle at
    ``PREFILL_TDM_ORACLE_LAYERS`` layers, one prompt, card against the CPU
    at fp32: the kept positions equal at each TDM layer, or differing only
    at near-ties (``PREFILL_TDM_NEAR_TIE``), the card's kept sets then
    replayed on the CPU; the card's argmax token's CPU logit within
    ``LM_ORACLE_TOL`` of the CPU's largest. Returns {"prefill tdm": the
    last TDM prefill's launch counts}."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import backend
    from repro_torch.models import prefill_prune as PP
    from repro_torch.tree import tree_map
    t_phase = time.perf_counter()
    pr = cfg.pruning
    tdm = cfg.replace(pruning=dataclasses.replace(
        pr, r_t=PREFILL_TDM_RT, tdm_layers=PREFILL_TDM_LAYERS))
    dense = cfg.replace(pruning=dataclasses.replace(pr, r_t=1.0,
                                                    tdm_layers=()))
    g = torch.Generator().manual_seed(21)
    toks = torch.randint(0, cfg.vocab_size, (PREFILL_TDM_B, PREFILL_TDM_N),
                         generator=g).to(dev)
    runs = {"tdm": lambda: PP.pruned_prefill_logits(tdm, params, toks),
            "dense": lambda: PP.pruned_prefill_logits(dense, params, toks)}
    counts, outs = {}, {}
    for kind, run in runs.items():
        backend.reset_launches()
        outs[kind] = run()
        torch.cuda.synchronize()
        counts[kind] = {k: v for k, v in backend.launches().items() if v}
    logits, n_final = outs["tdm"]
    L = cfg.num_layers
    require(n_final == PREFILL_TDM_FINAL and outs["dense"][1] ==
            PREFILL_TDM_N, f"prefill tdm: {n_final} tokens left, want "
                           f"{PREFILL_TDM_FINAL}")
    require(bool(torch.isfinite(logits).all()), "prefill tdm: logits not "
                                                "finite")
    want = {"tdm": {"flash_prefill_bf16": L,
                    "flash_decode_bf16": len(PREFILL_TDM_LAYERS)},
            "dense": {"flash_prefill_bf16": L}}
    require(counts == want, f"prefill tdm: launches {counts}, want {want}")
    walls = {k: [] for k in runs}
    for _ in range(PREFILL_TDM_REPEATS):
        for kind in ("tdm", "dense", "dense", "tdm"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs[kind]()
            torch.cuda.synchronize()
            walls[kind].append(time.perf_counter() - t0)
    busy = {}
    for kind, run in runs.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        busy[kind] = sum(r[2] for r in _device_rows(prof)) / 1e3
    w = {k: statistics.median(v) * 1e3 for k, v in walls.items()}
    print(f"prefill tdm: {cfg.name} uncut ({L} layers), {PREFILL_TDM_B} "
          f"prompts x {PREFILL_TDM_N} tokens, r_t {PREFILL_TDM_RT} at layers "
          f"{PREFILL_TDM_LAYERS}: n_tokens_final {n_final} (want "
          f"{PREFILL_TDM_FINAL}); wall median {w['tdm']:.2f} ms against the "
          f"dense prefill's {w['dense']:.2f} ms ({w['tdm'] / w['dense']:.3f})"
          f" over {2 * PREFILL_TDM_REPEATS} each in turns; device busy "
          f"{busy['tdm']:.2f} ms against {busy['dense']:.2f} ms "
          f"({busy['tdm'] / busy['dense']:.3f}); launches per TDM prefill "
          f"{counts['tdm']} (score rows: flash_decode_bf16 "
          f"{counts['tdm']['flash_decode_bf16']}), dense {counts['dense']}",
          flush=True)

    # the oracle at PREFILL_TDM_ORACLE_LAYERS layers
    n = PREFILL_TDM_ORACLE_LAYERS
    cut = {**params, "layers": params["layers"][:n]}
    c_card = tdm.replace(num_layers=n)
    one = toks[:1]
    with record_drops(torch) as seen_card:
        lc, _ = PP.pruned_prefill_logits(c_card, cut, one)
    cpu = torch.device("cpu")
    t0 = time.perf_counter()
    cut_h = tree_map(lambda t: t.to(cpu).float(), cut)
    c_cpu = c_card.replace(dtype="float32")
    with record_drops(torch) as seen_cpu:
        lh, _ = PP.pruned_prefill_logits(c_cpu, cut_h, one.cpu())
    layer_rows, replay = [], False
    for (tc, _), (th, sh) in zip(seen_card, seen_cpu):
        a, b = set(tc[0].tolist()), set(th[0].tolist())
        kth = torch.sort(sh[0], descending=True).values[len(b) - 1].item()
        gaps = [abs(sh[0, i].item() - kth) / kth for i in a ^ b]
        layer_rows.append((len(a ^ b) // 2, max(gaps, default=0.0)))
        if a != b:
            require(max(gaps) <= PREFILL_TDM_NEAR_TIE,
                    f"prefill tdm oracle: kept sets differ beyond near-ties "
                    f"at a TDM layer: {layer_rows}")
            replay = True
            break  # later layers see other sequences: replay the card's
    if replay:
        with record_drops(torch, [t for t, _ in seen_card]):
            lh, _ = PP.pruned_prefill_logits(c_cpu, cut_h, one.cpu())
    cpu_s = time.perf_counter() - t0
    top = int(lc[0].argmax())
    gap = (lh[0].max() - lh[0, top]).item()
    print(f"prefill tdm oracle at {n} of {L} layers, one prompt, card (bf16,"
          f" kernels) vs CPU (fp32, plain; {cpu_s:.1f} s): kept sets per TDM "
          f"layer (tokens swapped, largest |s - s_k| / s_k among them) "
          f"{layer_rows}, card's kept sets replayed on the CPU: {replay}; "
          f"the card's argmax {top} (CPU argmax {int(lh[0].argmax())}) "
          f"{gap:.4f} below the CPU's largest logit (tolerance "
          f"{LM_ORACLE_TOL})", flush=True)
    require(gap <= LM_ORACLE_TOL, f"prefill tdm oracle: the card's argmax "
                                  f"token {gap:.4f} below the CPU's largest")
    del cut_h
    print(f"prefill tdm: phase wall {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    return {"prefill tdm": counts["tdm"]}


# ---------------------------------------------------------------------------
# Phase 6b: MoE training of full-width Granite-MoE-3B-A800M
# ---------------------------------------------------------------------------
MOE_TRAIN_BATCH, MOE_TRAIN_SEQ = 8, 512
MOE_TRAIN_STEPS = 8  # step 0 (warm-up), then 7 timed; then 1 profiled
# Step 0 at 2 layers, batch 2 x 128, card against CPU, both with bf16
# activations, is held to the LM's bounds (``LM_TRAIN_*_TOL``) with the
# card's routing replayed on the CPU (``moe.route(expert=...)``). Left free,
# the CPU routes a few tokens a layer otherwise: the router is a bf16
# product rounded in another order on each side, so near ties flip (held
# by ``moe_route_flips``' rule), and a flipped token's other output moves
# the gradient of every later leaf by that token's rows. On an NVIDIA H100
# 80GB HBM3 at 700 W, 3 and 11 of 256 tokens flipped in layers 0 and 1 and
# the free CPU run's worst leaves were 12.1% (a layer-1 bank's scores) and
# 10.6% (the unembedding, whose label columns sum over one or two tokens)
# of their largest elements; those figures are printed, not gated.


@contextlib.contextmanager
def record_routes(torch, with_probs=False, replay=None):
    """Record every ``moe.route`` call while the block runs: yields a list
    of ``(expert, kept, probs or None)`` per call, on the route's device
    (read back only after the block). With ``replay`` (such a list from
    another run) call i takes that run's experts of its call i."""
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    seen, route = [], MOE.route

    def recorded(xf, p, cfg, capacity_factor=None):
        expert = (None if replay is None
                  else replay[len(seen)][0].to(xf.device))
        r = route(xf, p, cfg, capacity_factor, expert)
        probs = None
        if with_probs:
            with torch.no_grad():
                probs = torch.softmax(L.linear(xf, p["router"]).float(),
                                      dim=-1)
        seen.append((r.expert, r.kept, probs))
        return r
    MOE.route = recorded
    try:
        yield seen
    finally:
        MOE.route = route


def moe_route_flips(torch, card, cpu, top_k):
    """Per MoE layer, the tokens the card routes otherwise than the CPU,
    held to the MoE serve's near-tie rule: every expert in one side's set
    and not the other's lies within 2 d of the token's k-th largest CPU
    probability, d the layer's largest card-vs-CPU probability difference.
    Returns one dict per layer: ``routed`` (tokens with another expert
    set), ``kept`` (tokens routed alike whose kept pairs differ: the
    capacity shifted by a token routed otherwise earlier), ``d``,
    ``worst`` (the largest gap over 2 d; the rule holds at <= 1) and
    ``flips`` ((token, experts that differ, gap) for each)."""
    out = []
    for (e_c, k_c, p_c), (e_h, k_h, p_h) in zip(card, cpu):
        e_c, k_c, p_c = e_c.cpu(), k_c.cpu(), p_c.cpu()
        d = (p_c - p_h).abs().max().item()
        (s_c, o_c), (s_h, o_h) = (torch.sort(e, dim=1) for e in (e_c, e_h))
        kth = torch.sort(p_h, dim=1, descending=True).values[:, top_k - 1]
        routed = (s_c != s_h).any(dim=1)
        flips, worst = [], 0.0
        for t in torch.nonzero(routed)[:, 0].tolist():
            differ = sorted(set(s_c[t].tolist()) ^ set(s_h[t].tolist()))
            gap = max(abs(p_h[t, e] - kth[t]).item() for e in differ)
            worst = max(worst, gap / (2 * d) if d else math.inf)
            flips.append((t, differ, gap))
        kept = (~routed & (k_c.gather(1, o_c) != k_h.gather(1, o_h)).any(1))
        out.append(dict(routed=int(routed.sum()), kept=int(kept.sum()), d=d,
                        worst=worst, flips=flips))
    return out


def moe_step0_card_vs_cpu(torch, dev, cfg):
    """Step 0's loss and gradients (``make_grad_fn`` with pruning) of
    ``cfg`` cut to 2 layers, batch 2, seq 128, from
    ``launch/train.make_state_factory``'s seeds, on the card (the kernels)
    and twice on the CPU (plain attention), all with bf16 activations:
    routing freely, and replaying the card's routing. Returns the card's
    loss, the replayed and the free CPU losses, the CPU's seconds, the
    card's launches, ``moe_route_flips`` of the free run and, for each CPU
    run, per gradient leaf ``(max|card - CPU| / max|CPU|, max|card -
    CPU|, max|CPU|, path)``, worst first."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.launch import train as LT
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import flatten_with_path, path_str, tree_map

    small = cfg.replace(num_layers=2)
    st = LT.make_state_factory(small, AdamW(), dev, with_scores=True)()
    toks = torch.from_numpy(synthetic_lm_batch(
        small, ShapeConfig("t", 128, 2, "train"), DataConfig(), 0)["tokens"])
    fn = ST.make_grad_fn(small, True)
    backend.reset_launches()
    with record_routes(torch, with_probs=True) as seen_c:
        loss_c, _, g_c = fn(st["params"], {"tokens": toks.to(dev)},
                            st["scores"])
    launches = {k: v for k, v in backend.launches().items() if v}
    cpu = torch.device("cpu")
    params, scores = (tree_map(lambda t: t.to(cpu), st[k])
                      for k in ("params", "scores"))
    t0 = time.perf_counter()
    with record_routes(torch, replay=seen_c):
        loss_r, _, g_r = fn(params, {"tokens": toks}, scores)
    with record_routes(torch, with_probs=True) as seen_h:
        loss_h, _, g_h = fn(params, {"tokens": toks}, scores)
    cpu_s = time.perf_counter() - t0
    # the forward's calls, one a layer (the recompute's follow)
    flips = moe_route_flips(torch, seen_c[:2], seen_h[:2], cfg.moe_top_k)
    out = []
    for g in (g_r, g_h):
        rows = []
        for (path, a), (_, b) in zip(flatten_with_path(g_c),
                                     flatten_with_path(g)):
            d = (a.cpu().float() - b.float()).abs().max().item()
            m = b.float().abs().max().item()
            rows.append((d / m if m else float("inf"), d, m, path_str(path)))
        out.append(sorted(rows, reverse=True))
    del st, g_c, g_r, g_h, seen_c
    torch.cuda.empty_cache()
    return (loss_c.item(), loss_r.item(), loss_h.item(), cpu_s, launches,
            flips, *out)


def moe_train_path(torch, dev):
    """Phase 6b. MoE training (``models/steps.make_train_step``, the dense
    LM's step, AdamW in place) of full-width Granite-MoE-3B-A800M (32
    layers, D=1536, 24 query over 8 KV heads of Dh 64, 40 experts top-8,
    d_ff 512, vocab 49155; params from seed 0 drawn on the card, scores
    from seed 7, by ``launch/train.make_state_factory``) with
    ``launch/train``'s ``--prune`` config (block 16, r_b 0.5; per expert
    in the banks), batches of ``MOE_TRAIN_BATCH`` x ``MOE_TRAIN_SEQ``
    from ``synthetic_lm_batch`` by step, AdamW at ``LM_TRAIN_LR``. Gates:
    (a) the loss falls; (b) step 0 at 2 layers, batch 2 x 128, card
    against CPU (both bf16): every token the CPU routes otherwise, left
    free, within the near-tie rule; with the card's routing replayed on
    the CPU, the loss within ``LM_TRAIN_LOSS_TOL`` relative and each
    gradient leaf within ``LM_TRAIN_GRAD_TOL`` of its largest (the free
    run's printed); (c) two step-0 gradient computations at full
    size bitwise equal; (d) per step, ``flash_prefill_bf16`` 2 x 32 and
    ``flash_prefill_bwd_bf16`` 32 launches, no other entry point, no
    plain attention; (e) TF32 off. Returns the last step's launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.configs import GRANITE_MOE_3B_A800M
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, synthetic_lm_batch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.launch import train as LT
    from repro_torch.models import attention as A
    from repro_torch.models import moe as MOE
    from repro_torch.models import pruning_glue as PG
    from repro_torch.models import steps as ST
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves

    t_phase = time.perf_counter()
    require(not torch.backends.cuda.matmul.allow_tf32
            and not torch.backends.cudnn.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "moe train: fp32 matmuls must not run on TF32")
    cfg = LT.prune_config(GRANITE_MOE_3B_A800M)
    L, K = cfg.num_layers, cfg.moe_top_k

    # (b) step 0 at 2 layers on the card and on the CPU, both bf16
    loss_c, loss_r, loss_h, cpu_s, _, flips, rows, free = \
        moe_step0_card_vs_cpu(torch, dev, cfg)
    err_loss = abs(loss_c - loss_r) / abs(loss_r)
    print(f"moe train step 0 at 2 layers, batch 2, seq 128, card (kernels) "
          f"vs CPU (plain; {cpu_s:.1f} s for two runs), both bf16: tokens "
          f"routed otherwise by the free CPU run per layer "
          f"{[f['routed'] for f in flips]}, routed alike but kept otherwise "
          f"{[f['kept'] for f in flips]} (of 256; probabilities within d = "
          f"{[round(f['d'], 9) for f in flips]}, largest gap over 2 d "
          f"{[round(f['worst'], 3) for f in flips]}, the rule <= 1); "
          f"flips (token, experts, gap) "
          f"{[f['flips'][:6] for f in flips]}", flush=True)
    require(all(f["worst"] <= 1.0 for f in flips),
            f"moe train step 0: a token routed otherwise outside the "
            f"near-tie rule: {flips}")
    print(f"moe train step 0, the card's routing replayed on the CPU: loss "
          f"{loss_c:.6f} vs {loss_r:.6f} (rel {err_loss:.3g}, tolerance "
          f"{LM_TRAIN_LOSS_TOL:g}); gradients, worst max|d| / max|CPU| per "
          f"leaf of {len(rows)}: " + ", ".join(
              f"{r:.4g} ({p})" for r, _, _, p in rows[:4])
          + f" (tolerance {LM_TRAIN_GRAD_TOL:g}); routing freely (not "
          f"gated): loss {loss_h:.6f} (rel "
          f"{abs(loss_c - loss_h) / abs(loss_h):.3g}), worst leaves "
          + ", ".join(f"{r:.4g} ({p})" for r, _, _, p in free[:4]),
          flush=True)
    require(err_loss <= LM_TRAIN_LOSS_TOL,
            f"moe train step 0: loss card vs CPU rel {err_loss:.3g}")
    require(rows[0][0] <= LM_TRAIN_GRAD_TOL,
            f"moe train step 0: gradients card vs CPU, worst {rows[:3]}")

    opt = AdamW(lr=LM_TRAIN_LR, weight_decay=0.01)
    t0 = time.perf_counter()
    state = LT.make_state_factory(cfg, opt, dev, with_scores=True)()
    params, scores, opt_state = state["params"], state["scores"], state["opt"]
    del state
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    shape = ShapeConfig("t", MOE_TRAIN_SEQ, MOE_TRAIN_BATCH, "train")
    host = [synthetic_lm_batch(cfg, shape, DataConfig(), i)["tokens"]
            for i in range(MOE_TRAIN_STEPS + 1)]
    tokens = MOE_TRAIN_BATCH * MOE_TRAIN_SEQ
    C = MOE.moe_capacity(tokens, cfg.moe_num_experts, K,
                         cfg.moe_capacity_factor)
    print(f"moe train: {cfg.name} at full width and depth ({L} layers, "
          f"D={cfg.d_model}, {cfg.num_heads} query / {cfg.num_kv_heads} KV "
          f"heads, Dh={cfg.head_dim}, {cfg.moe_num_experts} experts top-{K}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab_size}), {n_params} params and "
          f"{sum(t.numel() for t in scores.values())} scores (block "
          f"{cfg.pruning.block_size}, r_b {cfg.pruning.r_b}; the banks' per "
          f"expert), fp32 with AdamW state, made in "
          f"{time.perf_counter() - t0:.2f} s; batch {MOE_TRAIN_BATCH} x "
          f"{MOE_TRAIN_SEQ} tokens, capacity {C} pairs an expert, bf16 "
          f"activations, remat {cfg.remat_policy}, lr {LM_TRAIN_LR:g}; "
          f"{torch.cuda.memory_allocated(dev) / 2 ** 30:.2f} GiB allocated",
          flush=True)

    # (c) two step-0 gradient computations, bitwise
    grad_fn = ST.make_grad_fn(cfg, True)
    b0 = {"tokens": torch.from_numpy(host[0]).to(dev)}
    loss_a, _, g = grad_fn(params, b0, scores)
    first = [t.cpu() for t in leaves(g)]
    del g
    loss_b, _, g = grad_fn(params, b0, scores)
    same = bool(torch.equal(loss_a, loss_b)) and all(
        torch.equal(a, b.cpu()) for a, b in zip(first, leaves(g)))
    del g, first, b0
    print(f"moe train: two step-0 gradient computations at {MOE_TRAIN_BATCH}"
          f" x {MOE_TRAIN_SEQ} bitwise equal: {same} (loss "
          f"{loss_a.item():.6f})", flush=True)
    require(same, "moe train: two step-0 gradient computations differ")

    step = ST.make_train_step(cfg, opt, with_pruning=True)

    def one(i):
        toks = torch.from_numpy(host[i]).to(dev)
        return step(params, opt_state, {"tokens": toks}, scores)

    def drops(seen):
        """The share of the forward's (token, expert) pairs dropped."""
        n = sum(int((~k).sum()) for _, k, _ in seen[:L])
        return n / (L * tokens * K)

    metrics, walls, counts, dropped = [], [], [], []
    with count_plain((FA, "attention_causal_plain"),
                     (A, "flash_attention_torch")) as plain_calls:
        torch.cuda.reset_peak_memory_stats(dev)
        for i in range(MOE_TRAIN_STEPS):
            torch.cuda.synchronize()
            backend.reset_launches()
            with record_routes(torch) if i == 0 else \
                    contextlib.nullcontext([]) as seen:
                t0 = time.perf_counter()
                params, scores, opt_state, m = one(i)
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            if i == 0:
                dropped.append(drops(seen))
            counts.append(backend.launches())
            metrics.append({k: v.item() for k, v in m.items()})
        peak = torch.cuda.max_memory_allocated(dev)
        torch.cuda.synchronize()
        ffn, mask = MOE.moe_ffn, PG.apply_pruning

        def ranged(name, fn):
            def call(*a, **kw):
                with record_function(name):
                    return fn(*a, **kw)
            return call
        MOE.moe_ffn = ranged("moe_ffn", ffn)
        PG.apply_pruning = ranged("apply_pruning", mask)
        try:
            with record_routes(torch) as seen, \
                    profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                params, scores, opt_state, m = one(MOE_TRAIN_STEPS)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
        finally:
            MOE.moe_ffn, PG.apply_pruning = ffn, mask
        dropped.append(drops(seen))
        last = {k: v.item() for k, v in m.items()}
    require(not any(plain_calls.values()),
            f"moe train: the plain attention ran on the card: {plain_calls}")
    want = {"flash_prefill_bf16": 2 * L, "flash_prefill_bwd_bf16": L}
    for i, n in enumerate(counts):
        got = {k: v for k, v in n.items() if v}
        require(got == want, f"moe train step {i}: launches {got}, want "
                             f"{want}")
    losses = [x["loss"] for x in metrics] + [last["loss"]]
    require(all(math.isfinite(x) for x in losses),
            f"moe train: a loss is not finite: {losses}")
    require(losses[-1] < losses[0], f"moe train: loss did not fall: {losses}")
    wall = statistics.median(walls[1:])
    print(f"moe train: losses {[round(x, 4) for x in losses]} (ce "
          f"{[round(x['ce'], 4) for x in metrics + [last]]}; aux summed over "
          f"{L} layers {metrics[0]['aux']:.4f} at step 0, {last['aux']:.4f} "
          f"at step {MOE_TRAIN_STEPS} ({L} when balanced); pairs dropped "
          f"{dropped[0]:.4f} at step 0, {dropped[1]:.4f} at step "
          f"{MOE_TRAIN_STEPS}); launches per step {want}, plain attention "
          f"calls 0", flush=True)
    print(f"moe train: wall per step median {wall * 1e3:.2f} ms over "
          f"{len(walls) - 1} steps after step 0 (min "
          f"{min(walls[1:]) * 1e3:.2f}, max {max(walls[1:]) * 1e3:.2f}; step "
          f"0 {walls[0] * 1e3:.1f} ms; the batch copied in the step): "
          f"{tokens / wall:.1f} training tokens/s; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB", flush=True)
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows)
    print(f"profile moe train step ({sum(r[1] for r in rows)} device "
          f"launches): wall {dt * 1e6:.0f} us profiled / {wall * 1e6:.0f} us "
          f"unprofiled median, device busy {busy_us:.0f} us, idle share "
          f"{1.0 - busy_us / (dt * 1e6):.3f} profiled / "
          f"{1.0 - busy_us / (wall * 1e6):.3f} unprofiled", flush=True)
    split = train_parts(rows, busy_us, "moe train")
    # host ranges' device time (subsets of the kernel groups above): every
    # aten::bmm is an expert GEMM; the backward's run under BmmBackward0
    total = {e.key: e.device_time_total for e in prof.key_averages()
             if e.device_type == DeviceType.CPU}
    bmm = total.get("aten::bmm", 0.0)
    bmm_bwd = total.get("autograd::engine::evaluate_function: BmmBackward0",
                        0.0)
    parts = {"expert GEMMs forward and recompute": bmm - bmm_bwd,
             "expert GEMMs backward": bmm_bwd,
             "the rest of moe_ffn forward and recompute (router, top-k, "
             "ranks, dispatch, SwiGLU, combine)":
                 total.get("moe_ffn", 0.0) - (bmm - bmm_bwd),
             "masks (apply_pruning forward)": total.get("apply_pruning", 0.0)}
    print("profile moe train step by host range: " + "; ".join(
        f"{k} {v / 1e3:.2f} ms ({v / busy_us:.3f})" for k, v in parts.items())
        + "; attention forward / backward "
        + " / ".join(f"{split[k][1] / 1e3:.2f} ms "
                     f"({split[k][1] / busy_us:.3f})"
                     for k in ("attention forward (flash_prefill_bf16)",
                               "attention backward (flash_prefill_bwd_bf16)"))
        + f"; AdamW {split['AdamW (multi_tensor_apply)'][1] / 1e3:.2f} ms; "
          f"casts and copies {split['casts and copies'][1] / 1e3:.2f} ms",
        flush=True)
    print(f"moe train: phase wall {time.perf_counter() - t_phase:.2f} s",
          flush=True)
    del params, scores, opt_state, m, prof
    torch.cuda.empty_cache()
    return counts[-1]


# ---------------------------------------------------------------------------
# Phase 6: training (Algorithm 1) at full width, the trained model served
# ---------------------------------------------------------------------------
TRAIN_BATCH = 64
TRAIN_TOTAL = 20   # the cubic schedule's total_steps (warm-up 2, cool-down 2)
TRAIN_STEPS = 11   # step 0 (card vs CPU, warm-up), then 10 timed steps
TRAIN_LR = 1e-4    # AdamW, the paper's weight decay 0.01
# Card vs CPU after step 0, fp32 both, other summation orders: the loss and
# its parts within 1e-5 relative to max(1, |ref|). Params and scores after
# the update, relative to max(1, |ref|): AdamW's first step moves an
# element by lr·g/(|g| + eps), so a gradient's rounding noise δ near eps
# = 1e-8 moves it by up to δ/eps of lr (0.146·lr measured on an NVIDIA
# H100 80GB HBM3 at 700 W); the bound is 0.5·lr, and 2·lr for the
# key biases (exact gradient 0: softmax ignores a shift of every key's
# logit, so their step is the sign of the noise). The same step with lr =
# eps = 1 moves an element by g/(|g| + 1), about its clipped gradient
# (~1e-2, far above the params' fp32 spacing), so its bound, 1e-5 on every
# leaf, holds the gradients themselves to 1e-5 (the clipped gradients
# agree to ~1e-7). The schedule's r_b on the card within 1e-6 of the
# CPU's.
TRAIN_LOSS_TOL = 1e-5
TRAIN_ADAM_TOL = 0.5
TRAIN_NOISE_TOL = 2.0
TRAIN_LINEAR_TOL = 1e-5


# A TDM's scores are the CLS row's attention probabilities, averaged over
# the heads: the card's and the CPU's of one token may differ by at most
# this (5.774e-08 measured on an NVIDIA H100 80GB HBM3 at 700 W,
# tools/train_probe.py --parts tdm).
TDM_SCORE_TOL = 1e-6


@contextlib.contextmanager
def record_kept():
    """Record, for every TDM that ``forward_vit`` runs, ``(kept, scores)``
    as host arrays: the kept body indices [B, k] in top-k order and the
    scores [B, N]. On the card they are read from ``token_drop_f32``'s
    index output (asked for even where the caller does not keep it; the
    output rows are the same bit for bit), on the CPU from ``TP.tdm``."""
    from repro_torch.core import token_pruning as TP
    from repro_torch.kernels.token_drop import ops as TD
    seen = []
    inner_card, inner_plain = TD._token_drop_cuda, TP.tdm

    def record(scores, idx):
        seen.append((idx.long().cpu().numpy(),
                     scores.detach().cpu().numpy()))

    def on_card(z, scores, k, with_idx):
        out, idx = inner_card(z, scores, k, True)
        record(scores, idx)
        return out, idx if with_idx else None

    def plain(z, scores, *a, **kw):
        out = inner_plain(z, scores, *a, **kw)
        record(scores, out[1])
        return out
    TD._token_drop_cuda, TP.tdm = on_card, plain
    try:
        yield seen
    finally:
        TD._token_drop_cuda, TP.tdm = inner_card, inner_plain


def kept_tokens(kept, n_tokens):
    """The tokens at each TDM, by identity: per TDM, ``(ids_in, chosen)``,
    the [B, N_t] ids of the sequence it takes and the [B, k] ids it kept
    in top-k order, where ids 0 .. n_tokens - 1 are the input's tokens
    (CLS, then the patches) and -(t + 1) is the fused token TDM t appends.
    A TDM keeps body positions (``kept``, [B, k] per TDM); a position after
    an earlier TDM holds the token its kept slot came from."""
    import numpy as np
    B = kept[0].shape[0]
    ids = np.tile(np.arange(n_tokens), (B, 1))
    out = []
    for t, idx in enumerate(kept):
        chosen = np.take_along_axis(ids[:, 1:], idx, axis=1)
        out.append((ids, chosen))
        ids = np.concatenate([ids[:, :1], chosen,
                              np.full((B, 1), -(t + 1))], axis=1)
    return out


def compare_kept(layers, n_tokens, seen_card, seen_cpu):
    """Gate (d)'s first part, per TDM (``record_kept``'s records): the
    card's and the CPU's scores of each token (by identity,
    ``kept_tokens``) within ``TDM_SCORE_TOL``, their largest difference d;
    then the kept tokens in top-k order, position by position. Where the
    two differ, the token each put there must be kept by the other too,
    and the two tokens' scores must lie within 2d of each other on the
    card and on the CPU: the most by which an order can flip between
    two sets of scores d apart. Such a pair only permutes rows (attention,
    the per-token layers and the fused sum ignore the order); the loss,
    parameter and score gates that follow hold the step itself. Returns,
    per TDM layer, d and the pairs that took each other's places, each
    once, as (row, card's token, CPU's token, their score gap on the card,
    on the CPU)."""
    import numpy as np
    card = kept_tokens([k for k, _ in seen_card], n_tokens)
    cpu = kept_tokens([k for k, _ in seen_cpu], n_tokens)
    out = {}
    for layer, (ids_a, ka), (ids_b, kb), (_, sa), (_, sb) in zip(
            layers, card, cpu, seen_card, seen_cpu):
        oa, ob = np.argsort(ids_a, axis=1), np.argsort(ids_b, axis=1)
        require(np.array_equal(np.take_along_axis(ids_a, oa, 1),
                               np.take_along_axis(ids_b, ob, 1)),
                f"train step 0, TDM at layer {layer}: the card and the CPU "
                f"take different tokens")
        d = float(np.abs(np.take_along_axis(sa, oa, 1)[:, 1:]
                         - np.take_along_axis(sb, ob, 1)[:, 1:]).max())
        require(d <= TDM_SCORE_TOL,
                f"train step 0, TDM at layer {layer}: card and CPU scores "
                f"differ by {d:.3g} (tolerance {TDM_SCORE_TOL})")
        pairs = []
        for row, j in zip(*np.nonzero(ka != kb)):
            x, y = int(ka[row, j]), int(kb[row, j])
            pos_a = {t: c for c, t in enumerate(ids_a[row])}
            pos_b = {t: c for c, t in enumerate(ids_b[row])}
            gap_a = abs(float(sa[row, pos_a[x]] - sa[row, pos_a[y]]))
            gap_b = abs(float(sb[row, pos_b[x]] - sb[row, pos_b[y]]))
            require(x in kb[row] and y in ka[row]
                    and max(gap_a, gap_b) <= 2 * d,
                    f"train step 0, TDM at layer {layer}, row {row}, kept "
                    f"position {j}: the card keeps token {x}, the CPU "
                    f"token {y} (kept by both: {x in kb[row]}, "
                    f"{y in ka[row]}), score gap {gap_a:.3g} on the card, "
                    f"{gap_b:.3g} on the CPU, against 2d = {2 * d:.3g}")
            if (int(row), y, x, gap_a, gap_b) not in pairs:
                pairs.append((int(row), x, y, gap_a, gap_b))
        out[layer] = (d, pairs)
    return out


def _step_errors(torch, card_tree, cpu_tree, lr):
    """Worst |card - cpu| / max(1, |cpu|) over the leaves, in units of
    ``lr``: (key biases, every other leaf), and the worst leaf's path."""
    from repro_torch.tree import flatten_with_path, path_str
    worst = {"bk": (0.0, ""), "other": (0.0, "")}
    for (path, a), (_, b) in zip(flatten_with_path(card_tree),
                                 flatten_with_path(cpu_tree)):
        b = b.float()
        err = ((a.cpu().float() - b).abs().max()
               / max(1.0, b.abs().max().item())).item() / lr
        key = "bk" if path and path[-1] == "bk" else "other"
        if err > worst[key][0]:
            worst[key] = (err, path_str(path))
    return worst


def train_path(torch, dev):
    """Algorithm 1 on full-width DeiT-Small: a student (seed 0, scores from
    the same generator) distilled from a dense DeiT-Small teacher (seed 1),
    batches of 64 from ``synthetic_vit_batch`` by step, AdamW at
    ``TRAIN_LR``, ``total_steps`` 20, ``TRAIN_STEPS`` steps. Gates: (a) the
    last step's loss below the first; (b) each step's r_b the cubic
    schedule's, non-increasing; (c) the scores moved; (d) step 0 on the
    card against the same step on the CPU (kept tokens at every TDM
    first, then the loss parts, params and scores); (e) the trained scores'
    hard masks packed and served by ``VisionEngine`` on the kernels,
    against the oracles, the kernel-free one on CPU copies; (f) every step
    on the card launches exactly ``vit_step_launches(cfg)`` (the student's
    attention forward and backward and TDM forward and backward at every
    layer and TDM, the teacher's attention forward) and no plain version of
    them runs on the card. Returns the trained serve's launch counts and
    the last timed step's."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import DEIT_SMALL
    from repro_torch.core import block_pruning as BP
    from repro_torch.core import complexity as CX
    from repro_torch.core import packed_runner as PR
    from repro_torch.core import schedule as S
    from repro_torch.core import simultaneous as SIM
    from repro_torch.core import token_pruning as TP
    from repro_torch.data import DataConfig, synthetic_vit_batch
    from repro_torch.kernels import backend
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.token_drop import ops as TD
    from repro_torch.models import attention as A
    from repro_torch.models import model as M
    from repro_torch.models import pruning_glue as PG
    from repro_torch.optim import AdamW
    from repro_torch.tree import leaves, tree_map

    require(not torch.backends.cuda.matmul.allow_tf32
            and torch.get_float32_matmul_precision() == "highest",
            "training: fp32 matmuls must not run on TF32")
    cfg = DEIT_SMALL
    p = cfg.pruning
    held_before = torch.cuda.memory_allocated(dev)
    opt = AdamW(lr=TRAIN_LR, weight_decay=0.01)
    state, _ = SIM.init_state(cfg, torch.Generator().manual_seed(0), opt,
                              device=dev)
    teacher = M.init_params(cfg, torch.Generator().manual_seed(1),
                            device=dev)
    step = SIM.make_simultaneous_step(cfg, cfg, opt, TRAIN_TOTAL)
    t0 = time.perf_counter()
    host = [synthetic_vit_batch(cfg, TRAIN_BATCH, DataConfig(seed=0), i)
            for i in range(TRAIN_STEPS)]
    print(f"train: {cfg.name} at full width and depth, batch {TRAIN_BATCH}, "
          f"{TRAIN_STEPS} of total_steps {TRAIN_TOTAL}, AdamW lr "
          f"{TRAIN_LR}, r_b {p.r_b} (cubic, warm-up 2, cool-down 2), r_t "
          f"{p.r_t} at layers {p.tdm_layers}; {len(leaves(state.params))} "
          f"param and {len(state.scores)} score tensors; batches made in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def on(dv, b):
        return {"patches": torch.from_numpy(b["patches"]).to(dv),
                "labels": torch.from_numpy(b["labels"]).to(dv)}

    # (d) step 0 on the card, then on the CPU from the same state and batch;
    # then both again at lr = eps = 1
    cpu = torch.device("cpu")
    state_cpu = tree_map(lambda t: t.to(cpu), state)
    teacher_cpu = tree_map(lambda t: t.to(cpu), teacher)
    want = vit_step_launches(backend, cfg)
    # the plain versions of the path's kernels and what they are made of
    plain_names = ((FA, "attention_plain"), (FA, "attention_bwd_plain"),
                   (A, "flash_attention_torch"), (A, "attention_probs_row"),
                   (TP, "tdm"), (TD, "token_drop_plain"),
                   (TD, "token_drop_bwd_plain"))
    backend.reset_launches()
    with record_kept() as seen_card, count_plain(*plain_names) as plain:
        state1, m0 = step(state, teacher, on(dev, host[0]))
    require(backend.launches() == want,
            f"train step 0: launches {backend.launches()}, want {want}")
    t0 = time.perf_counter()
    with record_kept() as seen_cpu:
        state1_cpu, m0_cpu = step(state_cpu, teacher_cpu, on(cpu, host[0]))
    cpu_s = time.perf_counter() - t0
    require(len(seen_card) == len(seen_cpu) == len(p.tdm_layers),
            f"train step 0: {len(seen_card)} TDMs on the card, "
            f"{len(seen_cpu)} on the CPU")
    n_tokens = (cfg.image_size // cfg.patch_size) ** 2 + 1
    kept_cmp = compare_kept(p.tdm_layers, n_tokens, seen_card, seen_cpu)
    margins = []
    for kept, sc in seen_card:
        srt = -np.sort(-sc[:, 1:], axis=1)
        k = kept.shape[1]
        margins.append(float((srt[:, k - 1] - srt[:, k]).min()))
    worst_loss = 0.0
    for k in ("loss", "ce", "distill", "reg", "r_b"):
        a, b = m0[k].item(), m0_cpu[k].item()
        err = abs(a - b) / max(1.0, abs(b))
        worst_loss = max(worst_loss, err)
        require(err <= TRAIN_LOSS_TOL, f"train step 0: {k} card {a!r} vs "
                                       f"CPU {b!r}")
    lin = SIM.make_simultaneous_step(
        cfg, cfg, AdamW(lr=1.0, eps=1.0, weight_decay=0.01), TRAIN_TOTAL)
    with count_plain(*plain_names) as plain_lin:
        lin_card = lin(state, teacher, on(dev, host[0]))[0]
    lin_cpu = lin(state_cpu, teacher_cpu, on(cpu, host[0]))[0]
    errs, errs_lin = {}, {}
    for what in ("params", "scores"):
        errs[what] = _step_errors(torch, getattr(state1, what),
                                  getattr(state1_cpu, what), TRAIN_LR)
        require(errs[what]["other"][0] <= TRAIN_ADAM_TOL
                and errs[what]["bk"][0] <= TRAIN_NOISE_TOL,
                f"train step 0: {what} after the update, card vs CPU, "
                f"worst in units of lr: {errs[what]}")
        errs_lin[what] = max(e[0] for e in _step_errors(
            torch, getattr(lin_card, what), getattr(lin_cpu, what),
            1.0).values())
        require(errs_lin[what] <= TRAIN_LINEAR_TOL,
                f"train step 0 at lr = eps = 1: {what} after the update, "
                f"card vs CPU, worst {errs_lin[what]:.3g}")
    print(f"train step 0 card vs CPU ({cpu_s:.1f} s on the CPU): kept "
          f"tokens equal at TDM layers {p.tdm_layers} (smallest score gap "
          f"at the k-th kept token per TDM on the card: "
          f"{[f'{g:.3g}' for g in margins]}); per TDM layer, the largest "
          f"card-vs-CPU score difference d by token and the kept tokens "
          f"that took each other's places in top-k order as (row, card's "
          f"token, CPU's token, their score gap on the card, on the CPU): "
          + str({k: (f"{d:.4g}", [(r, x, y, f"{ga:.4g}", f"{gb:.4g}")
                                  for r, x, y, ga, gb in v])
                 for k, (d, v) in kept_cmp.items()})
          + f"; loss parts max|d|/max(1,|ref|)"
          f" = {worst_loss:.3g} (tolerance {TRAIN_LOSS_TOL}); after the "
          f"update, worst |d|/max(1,|ref|) in units of lr: params "
          f"{errs['params']['other'][0]:.3g} ({errs['params']['other'][1]}),"
          f" key biases {errs['params']['bk'][0]:.3g}, scores "
          f"{errs['scores']['other'][0]:.3g} (tolerances {TRAIN_ADAM_TOL}, "
          f"{TRAIN_NOISE_TOL}); at lr = eps = 1: params "
          f"{errs_lin['params']:.3g},"
          f" scores {errs_lin['scores']:.3g} (tolerance {TRAIN_LINEAR_TOL})",
          flush=True)
    del state1_cpu, state_cpu, teacher_cpu, lin_card, lin_cpu

    # the timed steps
    scores0 = state.scores
    state, metrics, walls = state1, [m0], []
    torch.cuda.synchronize()
    held_steps = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with count_plain(*plain_names) as plain_steps:
        for i in range(1, TRAIN_STEPS):
            batch = on(dev, host[i])
            torch.cuda.synchronize()
            backend.reset_launches()
            t0 = time.perf_counter()
            state, m = step(state, teacher, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            metrics.append(m)
            step_counts = backend.launches()
            require(step_counts == want,
                    f"train step {i}: launches {step_counts}, want {want}")
    peak = torch.cuda.max_memory_allocated(dev)
    plain_calls = {name: plain[name] + plain_lin[name] + plain_steps[name]
                   for name in plain}
    require(not any(plain_calls.values()),
            f"training ran plain versions on the card: {plain_calls}")
    print(f"train: every step on the card launched "
          f"{ {k: v for k, v in want.items() if v} } and nothing else; "
          f"plain calls on the card {plain_calls}", flush=True)
    losses = [m["loss"].item() for m in metrics]
    rbs = [m["r_b"].item() for m in metrics]
    sched = [S.cubic_keep_rate(i, TRAIN_TOTAL, p.r_b, 2, 2).item()
             for i in range(TRAIN_STEPS)]
    require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
    require(all(abs(a - b) <= 1e-6 for a, b in zip(rbs, sched))
            and all(a >= b for a, b in zip(rbs, rbs[1:])),
            f"train: r_b {rbs} is not the cubic schedule {sched}")
    moved = max((a - b).abs().max().item() for a, b in
                zip(leaves(state.scores), leaves(scores0)))
    require(moved > 0, "train: the scores did not move")
    wall = statistics.median(walls)
    print(f"train: losses {[round(x, 4) for x in losses]}; r_b "
          f"{[round(x, 4) for x in rbs]} (the cubic schedule); scores moved "
          f"by up to {moved:.3g}", flush=True)
    print(f"train: wall per step median {wall * 1e3:.2f} ms over "
          f"{len(walls)} steps (min {min(walls) * 1e3:.2f}, max "
          f"{max(walls) * 1e3:.2f}; batch on the card before each step): "
          f"{TRAIN_BATCH / wall:.1f} training images/s; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB, of which {held_steps / 2 ** 30:.2f} GiB "
          f"allocated before the timed steps ({held_before / 2 ** 30:.2f} "
          f"GiB held by earlier phases, the rest this phase's state: the "
          f"student with its AdamW moments, and the teacher), so "
          f"{(peak - held_steps) / 2 ** 30:.2f} GiB for a "
          f"step's own tensors", flush=True)

    # device busy and idle share of one step (its result discarded)
    batch = on(dev, host[-1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, teacher, batch)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    rows = _device_rows(prof)
    busy_us = sum(r[2] for r in rows)
    print(f"profile train step ({sum(r[1] for r in rows)} device launches): "
          f"wall {dt * 1e6:.0f} us profiled / {wall * 1e6:.0f} us unprofiled "
          f"median, device busy {busy_us:.0f} us, idle share "
          f"{1.0 - busy_us / (dt * 1e6):.3f} profiled / "
          f"{1.0 - busy_us / (wall * 1e6):.3f} unprofiled", flush=True)
    for name in ("flash_attention_f32", "flash_attention_bwd_f32",
                 "token_drop_f32", "token_drop_bwd_f32"):
        mine = [r for r in rows if kernel_symbol(name) in r[0]]
        print(f"  {name}: {sum(r[1] for r in mine)} kernels, "
              f"{sum(r[2] for r in mine):.1f} us on the card per step",
              flush=True)
    for n, k, us in rows[:10]:
        print(f"  device {us:9.1f} us  {k:5d} calls  {n[:90]}", flush=True)

    # the trained model: hard masks, its size, then served on the kernels
    masks = PG.hard_masks(cfg, state.params, state.scores)
    kept_blocks = sum(int(m.sum().item()) for m in masks.values())
    n_blocks = sum(m.numel() for m in masks.values())
    heads = [BP.head_retained_ratio(m, cfg.num_heads).item()
             for path, m in masks.items() if path.endswith(("wq", "wk",
                                                            "wv"))]
    eng = make_engine(cfg, state.params, state.scores, 1, dev)
    packed_bytes = sum(pw.nbytes() for pw in eng.segments.packed.values())
    dense_bytes = sum(state.params["layers"][int(path.split("/")[1])]["attn"][
        path.split("/")[-1]].numel() * 4 for path in masks)
    print(f"train: trained model: attention block density "
          f"{kept_blocks / n_blocks:.4f} ({kept_blocks} of {n_blocks} "
          f"blocks), head retained ratio {statistics.mean(heads):.4f} "
          f"(mean over {len(heads)} q/k/v masks, min {min(heads):.4f}), "
          f"compression ratio {CX.compression_ratio(cfg, p):.4f} (analytic, "
          f"core/complexity), packed attention weights {packed_bytes} of "
          f"{dense_bytes} dense bytes", flush=True)
    serve_stream(torch, backend, eng)  # warm-up
    reqs, out, dt, counts, pipe = serve_stream(torch, backend, eng)
    require(sorted(out) == [r.uid for r in reqs],
            "trained fp32: not every request was served")
    require_launched(counts, "fp32", "trained fp32")
    require(pipe["host_syncs"] == 0, f"trained fp32: the engine waited on "
                                     f"the card {pipe['host_syncs']} times "
                                     f"outside its step events")
    print_serve("train: trained model fp32", out, [dt], counts,
                [pipe["host_syncs"]], pipe)
    check_against_oracle(torch, cfg, eng, reqs, out, "fp32", "trained fp32")
    n_patches = (cfg.image_size // cfg.patch_size) ** 2
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (2, n_patches, cfg.patch_size ** 2 * 3)),
        dtype=torch.float32).to(dev)
    y = PR.forward_vit_packed(cfg, eng.segments.params, eng.segments.packed,
                              x, use_tdm=False, device=dev).logits
    y_ref = masked_dense_on_cpu(cfg, state.params, state.scores, x)
    y = y.cpu()
    err = (y - y_ref).abs().max().item()
    scale = max(1.0, y_ref.abs().max().item())
    require(err <= 1e-4 * scale,
            f"trained: packed vs masked-dense: max|d|={err:.3g}")
    require(bool((y.argmax(-1) == y_ref.argmax(-1)).all()),
            "trained: packed vs masked-dense: top-1 differs")
    print(f"trained: packed (kernels) vs masked-dense forward_vit (plain, "
          f"on the CPU), no TDM: max|d| = {err:.3g} (tolerance 1e-4 x "
          f"{scale:.3g})", flush=True)
    return counts, step_counts


def vit_step_launches(backend, cfg):
    """The launches of one Algorithm-1 step on the card, by entry point:
    the student's attention forward (with lse) and backward at each of the
    L layers, its TDM forward (with indices) and backward at each TDM
    layer, and the teacher's attention forward (no TDM, no gradient)."""
    L, T = cfg.num_layers, len(cfg.pruning.tdm_layers)
    want = {name: 0 for name in backend.ENTRY_POINTS}
    want.update(flash_attention_f32=2 * L, flash_attention_bwd_f32=L,
                token_drop_f32=T, token_drop_bwd_f32=T)
    return want


def masked_dense_on_cpu(cfg, params, scores, x):
    """The kernel-free oracle's logits: ``masked_dense_reference`` on CPU
    copies of the params, scores and input, where ``forward_vit`` runs the
    plain versions (on the card it would run the very kernels it checks)."""
    import torch
    from repro_torch.core import packed_runner as PR
    from repro_torch.tree import tree_map
    cpu = torch.device("cpu")
    to_cpu = lambda t: t.to(cpu)
    return PR.masked_dense_reference(cfg, tree_map(to_cpu, params),
                                     tree_map(to_cpu, scores), x.to(cpu),
                                     use_tdm=False).logits


REPLACES = {  # the reference's pallas_call each kernel stands in for
    "sbmm.cu": "src/repro/kernels/sbmm/sbmm.py:75",
    "sbmm_quant.cu": "src/repro/kernels/sbmm/quant.py:80",
    "flash_attention.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    "flash_decode.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    "flash_prefill.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    # the gradient JAX takes of train-mode attention over that kernel
    "flash_prefill_bwd.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    # the gradient JAX takes of the ViT's non-causal attention and its TDM
    # scores in Algorithm 1 (the backward of token_drop.cu, the gradient of
    # the TDM, shares its source and row)
    "flash_attention_bwd.cu":
        "src/repro/kernels/flash_attention/flash_attention.py:92",
    "token_drop.cu": "src/repro/kernels/token_drop/token_drop.py:62",
    "token_package.cu":
        "src/repro/kernels/token_package/token_package.py:68",
    # the recurrences, which the reference runs as jax.lax.scan, not Pallas
    "mamba_scan.cu": "no Pallas kernel: jax.lax.scan at "
                     "src/repro/models/ssm.py:116",
    "wkv6.cu": "no Pallas kernel: jax.lax.scan at "
               "src/repro/models/ssm.py:234",
    # the gradient JAX takes of those scans when the families train
    "mamba_scan_bwd.cu": "no Pallas kernel: the gradient of jax.lax.scan "
                         "at src/repro/models/ssm.py:116",
    "wkv6_bwd.cu": "no Pallas kernel: the gradient of jax.lax.scan at "
                   "src/repro/models/ssm.py:234",
}


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    try:
        from repro_torch.kernels import backend
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing next to this "
              f"script ({ROOT}/src/repro_torch): {e}", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = backend.resolve_device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(dev)}", flush=True)

    build_s = backend.build(verbose=True)
    print(f"build: {build_s:.2f} s", flush=True)
    check_tensor_cores(backend)

    checks = [*check_sbmm(torch, dev),
              check_flash_attention(torch, dev, half=False),
              check_flash_attention(torch, dev, half=True),
              check_token_drop(torch, dev), check_token_package(torch, dev),
              *check_flash_attention_causal(torch, dev),
              *check_flash_attention_noncausal(torch, dev)]
    by_name = {c["name"]: c for c in checks}
    checks.append(check_causal_training(torch, dev,
                                        by_name["flash_prefill_bf16"]))
    checks.append(check_noncausal_training(
        torch, dev, by_name["flash_prefill_bf16/noncausal"]))
    checks.append(check_vit_attention_training(
        torch, dev, by_name["flash_attention_f32"]))
    checks.append(check_token_drop_training(torch, dev,
                                            by_name["token_drop_f32"]))
    checks.extend(check_ssm_scans(torch, dev))
    checks.extend(check_scan_training(torch, dev))
    require(sorted(c["name"] for c in checks)
            == sorted((*backend.ENTRY_POINTS, *backend.FORMS)),
            "a kernel entry point or form has no check")
    for check in checks:
        check["err"] = max(e[1] for e in check["errs"])
        for c in check.get("cases", [check]):
            c["err"] = max(e[1] for e in c["errs"])
            errs = "; ".join(f"{out}: max_abs_err={err:.3g} <= {tol:.3g}"
                             + (f" ({rule})" if rule else "")
                             for out, err, tol, rule in c["errs"])
            host = ("" if "host" not in c else
                    f" host_ms={c['host'][0]:.4f} (library "
                    f"{c['host'][1]:.4f}; issuing a call, no wait)")
            print(f"kernel {check['name']}: {c['shapes']} {errs} "
                  f"kernel_ms={c['ms']:.4f} plain_ms={c['plain_ms']:.4f} "
                  f"library_ms={c['library_ms']} ({check['library_call']}) "
                  f"bound_ms={c['bound_ms']:.5f} ({c['bound_by']})" + host,
                  flush=True)
        require(all(err <= tol for _, err, tol, _ in check["errs"]),
                f"kernel {check['name']} disagrees with its plain version")

    def mark(phase):
        print(f"{phase}: done at {time.perf_counter() - t_start:.1f} s",
              flush=True)

    mark("kernel checks")
    path_counts, syncs, model = main_path(torch, dev)
    mark("vision serves")
    lm_counts, lm_syncs, lm_model = lm_path(torch, dev)
    path_counts.update(lm_counts)
    syncs.update({f"lm {k}": v for k, v in lm_syncs.items()})
    mark("lm serves")
    profile_run(torch, dev, checks, *model)
    # the checks' closures hold their inputs on the card; nothing runs them
    # again
    for check in checks:
        for c in (check, *check.get("cases", ())):
            c.pop("fn", None)
            c.pop("library_fn", None)
    mark("vision profile")
    profile_lm(torch, dev, *lm_model)
    mark("lm profile")
    path_counts.update(prefill_tdm_path(torch, dev, *lm_model))
    del lm_model
    torch.cuda.empty_cache()
    mark("prefill tdm")
    moe_counts, moe_syncs = moe_path(torch, dev)
    path_counts.update(moe_counts)
    syncs.update(moe_syncs)
    mark("moe serves")
    ssm_counts, ssm_syncs = ssm_path(torch, dev)
    path_counts.update(ssm_counts)
    syncs.update(ssm_syncs)
    mark("ssm serves")
    path_counts.update(multimodal_path(torch, dev))
    mark("multimodal serves")
    traffic_counts, traffic_syncs = traffic_path(torch, dev, checks)
    path_counts.update(traffic_counts)
    syncs.update(traffic_syncs)
    mark("traffic")
    path_counts["lm train"] = lm_train_path(torch, dev)
    mark("lm train")
    path_counts["moe train"] = moe_train_path(torch, dev)
    mark("moe train")
    path_counts.update(ssm_train_path(torch, dev))
    mark("ssm train")
    path_counts.update(mm_train_path(torch, dev))
    mark("mm train")
    path_counts["trained fp32"], path_counts["vit train"] = train_path(
        torch, dev)
    mark("vit train")
    for key, n in syncs.items():
        require(not any(n), f"{key}: the engine waited on the card outside "
                            f"its step events: {n}")

    # a form's launches count under its entry point too: the entry's own
    # line keeps the launches of its other (causal) mode
    launches = {name: sum(c.get(name, 0) for c in path_counts.values())
                for name in (*backend.ENTRY_POINTS, *backend.FORMS)}
    for form, entry in backend.FORMS.items():
        launches[entry] -= launches[form]
    print(f"total: {time.perf_counter() - t_start:.2f} s", flush=True)
    print(json.dumps({"kernels": [
        {"name": c["name"], "route": "cuda",
         "source": f"src/repro_torch/kernels/csrc/{c['source']}",
         "replaces": REPLACES[c["source"]],
         "launches": launches[c["name"]], "max_abs_err": c["err"],
         "ms": c["ms"], "kernel_ms": c["ms"], "device_ms": c["device_ms"],
         "call_device_ms": c["call_device_ms"], "plain_ms": c["plain_ms"],
         "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
         "library_ms": c["library_ms"],
         "library_device_ms": c["library_device_ms"],
         **({"cases": [{k: case[k] for k in (
             "label", "max_abs_err", "ms", "device_ms", "call_device_ms",
             "plain_ms",
             "bound_ms", "bound_by", "library_ms", "library_device_ms")}
             for case in c["cases"]]}
            if "cases" in c else {})} for c in checks]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
