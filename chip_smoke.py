#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase carries on past its own):

1. print the card's name and power limit (nvidia-smi);
2. build the four CUDA kernels from `src/repro_torch/csrc` with nvcc (one
   process per source, started together) and print the build seconds and,
   for every kernel instantiation, ptxas's registers, stack and spill (a
   stack frame or a spill fails the run);
3. hold each kernel against its plain PyTorch version on the card over a
   shape sweep plus the main path's shapes: fp32 and bf16, ragged lengths,
   an all-zero slot, window and softcap; for the paged kernels also int8,
   fp8 and mixed-kind pools, G in {1, 2, 4, 5, 7, 8} (5 and 7 split as
   8 with the missing heads masked: hymba-1.5b's decode shape B 8, S 16,
   G 5, Dh 64, C 576 and llava-next-34b's B 2, S 16, G 7, Dh 128, each
   also at the other head dim), null-block tables and
   partial last blocks; for the multi-query (speculative-verify) kernel Q
   in {1, 3, 5} with ragged q_lens, and at Q = 1 bitwise equality with the
   single-query paged kernel; the slot kernel also bitwise against the
   paged kernel over an identity block table (lengths up to 1600), and the
   score kernel at B = 1 with T tails off its 64-key tile and W*G from 32
   to 256, and at the chunked-prefill shape (B = 1, 512 keys at positions
   from 0 to 1536, padded last chunks; tolerances stated at each check);
   then the paged kernels' bitwise contracts: every query of the multi-query kernel equals the
   single-query kernel at its causal length and q_pos + i (Q 1 to 40, the
   query chunks included), and both kernels are unchanged on pools whose
   blocks are relabelled through the table; every sweep also at head_dim
   256 (G 1, 2, 4, 8; gemma2-9b's decode and prefill shapes), at 192, and
   at the (G, Dh) pairs of the other configs phases 16 and 17 serve (the
   contracts at Dh 256 too; the score kernel at hymba's and llava's
   prefill shapes, W*G = 160 and 224); the multi-query kernel must raise
   at G = 5 and 7;
4. check the port's CUDA path against its own CPU path on minitron-8b smoke
   (same weights, fp32): identical tokens and lengths, close logits; then
   speculative `run_trace` (full-depth and 1-layer drafts) against the
   card's plain paged run and the CPU's spec run: identical tokens;
5. the main path at full width: minitron-8b (d_model 4096, 32/8 heads,
   vocab 256000; phases 5-15 cut to 8 of its 32 layers, ``MAIN_LAYERS``, to
   keep the script inside its time limit) in bf16 with random weights from
   a seed, 8 shards x 2
   slots, Ada-SnapKV (budget 256 -> capacity 576), B=8 prompts of T=2048
   tokens, 32 new tokens: `measure_profile`, then `generate` under sha,
   fairkv_nodp and fairkv_dp.  Launch counters are zeroed just before and
   read just after each phase; asserts the launch counts, plan-invariant
   retained lengths and a bf16 logit bound; prints timings, plan metrics,
   memory; then one torch.profiler pass over decode steps;
6. one-shot `generate` on the paged backend (fairkv_dp, block size 16):
   bf16 pools next to the slot run (lengths bitwise, logit gap under the
   bf16 bound, 32 paged-kernel launches per step, no slot-kernel launch),
   then int8 and fp8 pools against the bf16 pools (logit cosine, argmax
   agreement; bars in QUANT_BARS); one profiled step per pool format
   (device time, `prepare_decode` host time);
7. continuous batching: a 24-request Poisson trace (prompts 512-2048
   tokens, 16-64 new tokens) through `Engine.run_trace` with 8 rows and
   online replanning, on the slot backend, bf16 pools, int8 pools and an
   undersized fp8 pool that must preempt; every request must finish, every
   pool end empty, and the slot and bf16-pool runs give identical tokens
   and replan decisions; then self-speculative decoding on the same trace:
   (e) a 2-layer draft with adaptive depth, (f) the full-depth self-draft
   (acceptance >= 0.90) on bf16 pools, (g) (e)'s draft on int8 pools;
   (e) against the bf16 run: logit gap under the bf16 bound while the
   tokens agree and every divergence a near-tie; one profiler pass over
   continuous decode ticks and one over speculative ticks;
8. chunked prefill and prefix reuse (bf16 pools, chunks of 512 tokens,
   8 rows) on phase 7's arrivals with prompts of 1536-2048 tokens, 75% of
   them starting with one of two 1024-token templates: (h) policy "none",
   chunking only, and (i) with sharing: identical tokens for all 24
   requests, prefix hits, refcount > 1 while requests are live, fewer
   peak blocks per layer, an empty pool after flushing the index; (j)
   copy-on-write when a donor's ring wraps into its shared prefix, the
   late sharer's tokens equal to an unshared engine's; (k) Ada-SnapKV
   with sharing beside phase 7's bf16 configuration on the same trace
   (peak blocks, TTFT, tokens/s, share of equal tokens);
9. CUDA graphs against eager execution at full width.  Every phase above
   runs its decode, propose, verify and chunk steps as CUDA graphs
   (`repro_torch.exec.local`; prefill stays eager); each continuous run
   captures them in `Engine.warmup` and fails if its trace captures again
   (graphs are keyed by the storage they run on, so a replan, splice or
   retirement that allocated new tensors would show as a capture).  This
   phase runs eagerly: one-shot fairkv_dp (phase 5's tokens and lengths,
   the logit gap printed and bounded), (b) (tokens and replan decisions),
   (e) (tokens and acceptance) and (i) (tokens, hits, copy-on-write), each
   on its whole trace, and prints host-clocked and device time per
   one-shot step, continuous tick, speculative tick and chunk step,
   graphed and eager (a pass with no device time fails);
10. time each kernel, its plain version and the PyTorch library call where
   one exists on the main path's own inputs (device time from CUDA events,
   median of 25 runs after warmup, L2 flushed before each run; snapkv
   also at B = 1 and at the chunk shape) beside the least time the card
   could take, and print them as one JSON line; the host time per call of
   kernels 1 and 2; phase 16 adds kernels 1-3 at gemma2-9b's shapes
   (``*_gemma2`` keys: kernels 1 and 3 on its one-shot's own cache,
   kernel 2 at its prefill shape); wherever kernel 1 is timed at another
   shape (phases 16, 17, 18 and 21: Dh 256 global / window, G 5, G 7, int8
   weights, B 1 at C 131,136) the efficient SDPA on the same inputs is
   timed beside it, the same way (``library_ms_*`` keys; without the
   softcap, which SDPA has not);
11. after the timings, so that kernel 1 is timed on the main path's own
   cache: the decode step's ops by input shapes under torch.profiler (one
   eager step on the main engine, which fails if it copies a slot weight:
   the einsum relayout that was the 7.2 ms elementwise kernel); then one
   engine serving one-shot and continuous at once (slot backend, 8
   scheduler rows, so the one-shot state and the scheduler's have one
   layout): generate, a one-shot replan, generate, `warmup`, then the
   first 4 requests of phase 7's trace with a generate after tick 4.
   Graphed and eager engines driven alike give the same one-shot tokens
   and logits and the same trace tokens; the first generate gives phase
   5's tokens; the graphed engine captures one decode graph per live
   state and nothing more;
12. (runs after phase 9 and before the timings, so its launches are in the
   kernel table) the six compression policies at phase 5's width: one-shot
   B = 8, T = 2048, 32 new tokens under streaming_llm, snapkv, pyramidkv,
   h2o, ada_snapkv and headkv (also with phase 5's measured profile as
   head_importance), each under sha and fairkv_dp (CH = 4) planned from the
   policy's own measured profile; bars: lengths bitwise plan-invariant,
   balanced policies keep exactly min(budget_l, T, C) per head,
   `layer_keep_bound` >= the realized sum of keep per layer and row, phase
   5's logit bound; prints the retained sum per layer, the per-shard load
   max/mean under both plans, plan efficiency, the graphed step's host and
   device time and kernel 1's time per step.  Then phase 7's (b) under
   headkv with obs on and off (identical tokens, no capture during the
   trace read from stepfn_compiles_total, Prometheus text and Chrome trace
   that parse; the tick medians) and (c)'s int8 pools with
   `plan_kv_dtypes` overrides (every request finishes, the pool ends empty);
13. `python -m repro_torch.launch.serve --arch minitron-8b --continuous
   --policy headkv --cache-backend paged` in a subprocess at full width and
   depth with a few requests, metrics and trace written under chiprun_out/: exit
   0, both files parse; then `serve --http --port 0` (paged pools, 4 rows)
   in a subprocess: the script waits for its `serving on` line, sends two
   requests, then SIGTERM: exit 0, the drain line, metrics that parse;
14. (after phase 13, before the timings, so its launches are in the kernel
   table) the multi-tenant front end at phase 7's configuration (b) with
   replanning off: (a) a bursty three-tenant trace of 48 requests (seed 7,
   batch 3x the others, bursts of 16 every 10 steps, fig10's classes)
   through `run_frontend_trace` under admission "slo" and "fcfs", each on a
   fresh engine: every request terminal with a recorded reason, fcfs
   rejecting none, the pool empty, no capture, launches equal to the
   prefills and decode ticks; prints goodput per step, SLO attainment per
   tenant, rejections, degradations, preemptions and the front end's host
   time per pump; (b) `FrontendServer` on 127.0.0.1 over a graphed engine,
   driven by an asyncio client: one prompt via /v1/generate and /v1/stream
   equal to `Engine.stream` bitwise (SSE order checked), twelve concurrent
   requests over three tenants with one client leaving after 3 tokens
   (cancelled), a drain with requests live and queued and a 503 for a
   request sent after it began; the pool empty, no capture, /metrics with
   the front end's seven families; prints TTFT per tenant and the SSE gap
   beside the tick;
15. (last, after phase 11) the multi-GPU executor (`repro_torch.exec.mesh`):
   (a) one NCCL rank, graphed, at phase 5's width: the fairkv_dp one-shot
   gives phase 5's tokens, logits and lengths bitwise; the first 8
   requests of phase 7's trace on bf16 pools, plain and with (e)'s
   speculation, and the first 4 with 256-token chunks give a local
   executor's tokens on the same trace bitwise; decode, propose, verify
   and the chunk step captured once each and never during a trace, their
   all-reduces inside the graphs; per decode and verify step 32
   all-reduces over model and no all-gather (the collective counter).
   (b) two gloo ranks sharing the card (model = 2), eager, each building
   the seed weights (checksum equal to the parent's): phase 5's one-shot
   on the slot backend and bf16 pools (prefill lengths bitwise, logit gap
   under the plan bar, the ranks' tokens identical), then the first 8
   requests of phase 7's trace (all finish, both partitions end empty).
   Prints step times, collectives and bytes per step and each rank's
   `max_memory_allocated`, and the phase's time and launches (apart from
   the kernel table);
16. (after phase 15, its memory freed) the other configs the port serves,
   launches stated apart from the kernel table: (a) the smoke variants of
   gemma2-9b, granite-3-2b, qwen1.5-110b, granite-moe-1b-a400m and
   qwen3-moe-30b-a3b on the card against the port's CPU path (fp32, same
   weights): one-shot and continuous on paged pools, speculative (1-layer
   draft) and chunked for the dense three; identical tokens and lengths,
   logits within 1e-3.  (b) gemma2-9b at full width cut to 10 of 42
   layers (head_dim 256, bf16, seed 0): one-shot B = 4 prompts of T = 4608
   (past the 4096-token window) under sha and fairkv_dp (lengths bitwise,
   the logit gap under the bf16 bound, a kernel 1 launch per layer and
   step and one kernel 2 launch per layer, eager == graphed tokens),
   kernels 1-3 timed at its shapes, then 4 requests of phase 7's trace on
   bf16 pools, the same with a 2-layer draft, and 4 with 512-token chunks
   (all finish, pools empty, nothing captured during a trace).  (c)
   granite-3-2b (cut to 10 of 40 layers) and (d) granite-moe-1b-a400m at
   full width and depth: the one-shot of
   phase 5's shape under both planners and 4 requests on bf16 pools
   (phase 16's traces ran 8 requests until phase 17 needed the time);
   MoE's eager run bitwise the graphed one, its speculative config
   refused, its plans' logit gap reported (a plan's bf16 rounding can
   flip a near-tied expert pick, which the smooth bound does not cover).
   (e) cut in depth: qwen1.5-110b to 4 of 80 layers with
   non-zero qkv biases (one-shot under both planners, then a replan
   between ticks of 4 requests: every live slot holds its head's biases
   under the new plan, bitwise) and qwen3-moe-30b-a3b to 8 of 48 layers
   (one-shot).  Prints per config prefill s, step ms host and device,
   `max_memory_allocated`, launches and seconds;
17. (after phase 16, its memory freed) the SSM, hybrid, encoder-decoder and
   VLM families, bf16, seed 0, 8 shards x 2 slots, phase 5's compression,
   launches stated apart from the kernel table: (a) the smoke variants of
   mamba2-1.3b and hymba-1.5b (one-shot and continuous on paged pools),
   hymba at G = 5 (n_kv_heads 1; both), whisper-small, llava-next-34b and
   llava at G = 7 (14 / 2 heads; one-shot) on the card against the port's
   CPU path (fp32, same weights): identical tokens and lengths, logits
   within 1e-3.  (b) hymba-1.5b at full width and depth (32 layers, 25 / 5
   heads, G 5, window 1024, SSD 25 x 64 with state 16; ~1.4 B parameters):
   one-shot B = 8, T = 2048 under sha and fairkv_dp (lengths bitwise, the
   logit gap under the bf16 bound, 32 kernel 1 launches per step, eager ==
   graphed tokens, the per-shard load max/mean of both plans: 5 kv heads
   over 8 shards), kernels 1-3 timed at its shapes, then 8 requests of
   phase 7's trace on bf16 pools (all finish, pool empty, no capture
   during the trace).  (c) mamba2-1.3b at full width cut to 12 of 48
   layers (64 SSD heads x 64, state 128): one-shot B = 8, T = 2048 with no kernel
   launched, eager == graphed, then 8 requests on the slot backend with
   imbalance 1.0.  (d) whisper-small at full width and depth (12 + 12
   layers): one-shot B = 8 over 1500 stub frames with a 256-token decoder
   prompt under both planners, (b)'s bars.  (e) llava-next-34b at full
   width cut to 12 of 60 layers (~7.6 B; ~69 GB of weights at full depth
   leave no room on one card): one-shot B = 2 of 2880 image + 1024 text
   tokens under both planners, (b)'s bars, kernels 1-3 timed at G 7 and
   kernel 2 at T 3904.  Prints per config prefill s, step ms host and
   device, `max_memory_allocated`, launches and seconds;
18. (after phase 17, its memory freed) weight-only int8 and training,
   launches stated apart from the kernel table: (a) the widened
   minitron-8b smoke config (d_model 256, vocab 128) with int8 weights on
   the card against the port's CPU path (tokens and lengths equal, logits
   within 1e-3); then minitron-8b at full width and depth with
   `quantize_serve_params` on each engine's serve tree, phase 5's plan
   and compression, one-shot B = 8 x T = 2048, 32 new tokens through the
   local executor and kernels 1 and 2: a bf16 sha run, whose tokens
   teacher-force int8 runs under sha and fairkv_dp (launches, lengths
   bitwise across the plans, their logit gap under the bf16 bound, eager
   == graphed tokens and lengths, the mesh executor refusing the tree);
   prints argmax agreement and logit gap against bf16, the weights' bytes
   in int8 and bf16, step host / device ms, kernel 1's ms and
   `max_memory_allocated`; kernels 1 and 2 timed on the int8 run's cache
   (``*_int8w`` keys).  (b) the flash-attention backward against autograd
   through `dense_attention` at one of granite-3-2b's layers (B 1, T
   4096, 32 / 8 heads, Dh 64, fp32, windows 0 / 1024, softcaps 0 / 50;
   within 1e-3 max|grad|), the six families' smoke training on the card
   against the CPU (loss after two steps within 1e-3), and granite-3-2b
   training at full width cut to 10 of 40 layers (`TRAIN_LAYERS`), bf16
   params and fp32 master / mu / nu, B 2 x S 4096, remat, 4 steps of
   `make_train_step` through `TrainingSupervisor.run`: finite loss and
   grad norm, params bf16, master fp32; prints step s, tokens/s, 6 N
   tokens / step / 989 TFLOP/s, memory, the losses).  (c) `python -m
   repro_torch.launch.train --arch granite-3-2b --smoke --steps 6
   --ckpt-every 3` in a subprocess, then `--resume` from its step-3
   checkpoint: the step-6 tree bitwise the uninterrupted run's (the two
   subprocesses run beside phases 19 and 20, which time nothing on the
   card; their line comes after phase 20's);
19. (after phase 18; host only apart from (b)) the production dry run
   (`repro_torch.launch.dryrun`) on fake tensors under a fake process
   group: first the kernels' fake implementations' scratch sizes against
   their libraries' at the main path's and the dry run's shapes; (a) the
   mesh executor's decode step at decode_32k on the (data 16, model 16)
   mesh for minitron-8b and qwen1.5-110b at full depth: exactly n_layers
   all-reduces over model of B / 16 x d_model bf16 each, no all-gather
   over model, and over data only the step's two output gathers (tokens
   and logits); prints rank 0's argument and peak bytes and whether they
   fit the card; (b) the dry run's prediction against the card: the peak
   bytes of phase 5's one-shot at a (1, 1) mesh (minitron-8b at
   ``MAIN_LAYERS`` layers, B 8 x T 2048, capacity 576), prefill and one
   eager decode step through the mesh executor, predicted on fake tensors
   and measured by ``torch.cuda.max_memory_allocated`` over the same real
   steps on one gloo rank (reset before each, counted from the memory
   allocated before the step's arguments), within 10%; (c) the
   single-mesh sweep of all ten archs at decode_32k (the fake 32k
   prefills take tens of seconds a cell; from a subprocess started after
   the build): every cell ``ok`` or
   ``skipped``, none ``fail`` (the dense and MoE archs' cells execute the
   cell step: phases 20 (c) and 21 (c) read them);
   prints the counts and
   the phase's seconds;
20. (after phase 19) the serve cells' step under ``serve_rules``
   (`repro_torch.launch.specs.serve_step`: `prefill` / `decode_step` on a
   rank's shards, ff and vocab split over model), launches stated apart
   from the kernel table: (a) one NCCL rank (model 1, data 1) runs phase
   5's fairkv_dp one-shot (``MAIN_LAYERS`` layers, B 8 x 2048, 32 tokens
   fed phase 5's teacher tokens) through it, seed weights rebuilt: tokens
   equal, lengths bitwise, logit gap under the plan bar against phase 5's
   local executor run (prints whether bitwise), the decode contract (2·L +
   1 all-reduces over model, one argmax pair gather, nothing over data);
   (b) the same on two gloo ranks sharing the card (model 2, eager;
   spawned from a thread, so (a) runs meanwhile): the plan bar, argmax
   agreement printed, the contract, each rank's MLP and
   vocab weights half the whole tree's, and each rank's
   ``max_memory_allocated`` over the prefill and the first decode step
   within 10% of the fake-tensor prediction of the same (model 2) steps;
   (c) phase 19 (c)'s records of the four dense archs: each executed the
   cell step and held the contract, qwen1.5-110b's peak fits the card;
   prints args, peak and collectives and the phase's seconds;
21. (after phase 20) long_500k's split-S decode and the MoE cells'
   expert parallelism through the cell step, launches stated apart from
   the kernel table: (a) gemma2-9b at full width cut to 4 of 42 layers
   (two local, two global), B 1, policy none at capacity 131,072 (+ 64
   ring columns; the cell's 524,288 cut so the local executor's whole
   cache fits beside the ranks'), a state from seed 0 with per-(slot,
   row) lengths from 100,000 to the capacity and each layer's first
   owned slot full (its appends wrap the ring), 16 decode steps: the
   local executor (graphed), one NCCL rank (data 1: the full-output
   kernel) bitwise its tokens, logits, lengths and written entries, two
   gloo ranks (data 2: the columns split, kernel 1's partial variant,
   one (o, lse) all-gather a layer) with tokens equal, lengths, the
   written entries' places, positions and layer 0's K / V bitwise, later
   layers' K / V and the logits within n_layers 2^-8 max|value|, the
   contract, first-step peaks within 5% of the fake prediction; the
   partial kernel against its plain version on the local run's cache
   (Dh 256, a global and a window layer, empty shards) and timed at C_loc
   65,536 beside its bound, plain version and the efficient SDPA with
   log-sum-exp, kernel 1 timed at (B 1, C 131,136); (b) phase 16's
   granite-moe one-shot (full width and depth, fairkv_dp) through the
   cell step: one NCCL rank bitwise the local executor, its prefill's
   dropped replicas per layer equal to the local prefill's; two gloo
   ranks (model 2, 16 experts a rank): the contract, expert / router /
   vocab bytes halved, peaks within 5% of the prediction, the logit gap,
   argmax agreement and drops reported beside phase 16's plan-to-plan
   gap; (c) the five new dry-run cells' records (the MoE decode cells
   from phase 19 (c), gemma2-9b long_500k and the MoE prefill_32k cells
   from a subprocess started before phase 20): each executed its step
   and held its contract;
22. (after phase 21) the SSM, hybrid, encoder-decoder and VLM cells'
   step, launches stated apart from the kernel table: (a) phase 17's
   one-shots of mamba2-1.3b and hymba-1.5b (8 x 2048, full width and
   depth), whisper-small (8 x 256) and llava-next-34b (12 of 60 layers)
   through the cell step on one NCCL rank: tokens, logits, lengths and
   the final SSD state, conv window and cross K / V bitwise the local
   executor's (eager) run, the derived decode collectives, kernel 1 and
   2's launches; (b) the same archs cut (mamba2 and hymba 4 layers x 512
   tokens, whisper 4 decoder layers, llava 2 layers x (2880 + 128)) on two
   gloo ranks sharing the card (model 2: mamba2's in_proj split across
   its z | xBC | dt boundaries and its heads split; hymba's conv channels
   and slots split, in_proj and heads whole; whisper's heads split), run
   beside (a): the logit and state gaps under n_layers 2^-8 max|local|
   against a local run of the cut config, argmax agreement printed, the
   derived collectives, peaks within 5% of the fake prediction; (c)
   hymba-1.5b's long_500k cell at full width cut to 4 of 32 layers (B 1,
   window 1024 + the 64-column ring, a seed-0 state, 72 steps: the ring
   wraps), the local executor, one NCCL rank bitwise it (tokens, logits,
   lengths, written entries, SSD state, conv window), two gloo ranks
   (data 2: kernel 1's partial variant at G 5, Dh 64, window 1024) with
   tokens equal and the rest within phase 21's bars; the partial kernel
   against its plain version on the local run's cache and timed beside
   its bound, plain version and the efficient SDPA (the ``*_g5`` keys of
   its row); mamba2-1.3b's long_500k (B 1, no cache, 12 of 48 layers) on one
   NCCL rank, bitwise; (d) the ten new dry-run cells' records (decode_32k
   and prefill_32k of the four archs, hymba's and mamba2's long_500k, from
   a subprocess started after the build): each executed its step and held
   its derived collectives;
23. (after phase 22) the dense train cells' step
   (`repro_torch.launch.specs.train_step`: `train_step` on a rank's shards
   under ``train_rules``), TF32 off: (a) granite-3-2b at full width cut to
   4 of 40 layers, bf16 params, fp32 master / mu / nu, B 2 x 4096 (the
   flash path), seed-0 weights, two `SyntheticLM` steps at lr 1e-3, remat:
   the cell step on one NCCL rank (mesh (1, 1)) against the local
   `make_train_step`, both under deterministic algorithms: every metric
   of every step and every param and master / mu / nu leaf bitwise, the
   per-step collectives those `dryrun.train_collectives` derives at (1, 1)
   (none), both eager step times; (b) the same at 2 layers in fp32, B 2 x
   2048, on two gloo ranks sharing the card at (data 1, model 2) and
   (data 2, model 1), beside (a): each step's loss, xent, grad norm and lr
   within 1e-4 (relative) of the local fp32 step's, each rank's param,
   master, mu and nu shards within 1e-4 of the local result's slice, its
   first step's ``max_memory_allocated`` within 5% of the fake-tensor
   prediction, the derived collectives; (c) the eight dense train_4k
   records (the four dense archs on both production meshes, from two
   subprocesses started after the build): each executed its step, held
   its derived collectives and fits; prints argument / temp / peak GB a
   rank;
24. (after phase 23) the MoE, SSM, hybrid, encoder-decoder and VLM train
   cells' step, TF32 off: (a) granite-moe-1b-a400m, mamba2-1.3b,
   hymba-1.5b, whisper-small and llava-next-34b at full width cut to 2
   layers (whisper 2 encoder + 2 decoder), bf16 params, fp32 master / mu /
   nu, B 2 x the train_4k row (4096 positions; llava's 2880 image + 1216
   text), two `SyntheticLM` steps at lr 1e-3, remat: the cell step on one
   NCCL rank (mesh (1, 1)) against the local `make_train_step`, both under
   deterministic algorithms: every metric and every param and master / mu
   / nu leaf bitwise, no collective; (b) the same five at 1 layer (whisper
   1 + 1) in fp32, B 2 x 1024 (llava 2880 + 256), two gloo ranks sharing
   the card at (data 1, model 2), beside (a) (llava's, whose whole tree
   takes turns, only once (a)'s llava has left the card), Adam's eps 1e-6
   (`P24_OPT`): metrics within 1e-4 (relative) of the local fp32 step's,
   each rank's param, master, mu and nu shards within 1e-4 of the local
   result's slice (the worst leaf named), the first step's
   ``max_memory_allocated`` within 5% of the fake prediction, the derived
   collectives; (c) the twelve new train_4k records (granite-moe,
   qwen3-moe, mamba2, hymba, whisper and llava on both production meshes,
   from two subprocesses started after the build): each executed its
   step, held its derived collectives and fits; prints argument / temp /
   peak GB a rank;
25. last line: {"ok": true, "device": {...}}.

Without CUDA, or run from a directory that does not hold the repository's
`src/repro_torch`, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import gc
import itertools
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# main-path configuration (phase 5)
ARCH = "minitron-8b"
# phases 5-15 run minitron-8b at full width cut to 8 of its 32 layers, so
# that the whole script ends well inside its time limit (at full depth it
# took 1036 s of the 1200); phase 13's CLI and phase 18 (a) run it at full
# depth
MAIN_LAYERS = 8
N_SHARDS, SLOTS_PER_SHARD = 8, 2
B, T, GEN = 8, 2048, 32
BUDGET, ALPHA, OBS, POOL, SINK, MARGIN = 256, 2.0, 32, 7, 4, 64
PLANNERS = (("sha", 0), ("fairkv_nodp", 0), ("fairkv_dp", 4))
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet, dense): HBM bytes/s, bf16 FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12  # outside the tensor cores

FP32_TOL = 1e-4  # fp32 kernel vs fp32 plain version: only the summation order differs
BF16_ULP = 2.0 ** -7  # one bf16 rounding step, relative (8-bit significand)
# paged kernel vs its plain version: the reference's own bars for its TPU
# kernel (tests/test_paged_kernel.py) — 1e-5 absolute with fp32 outputs
# (fp32 and int8/fp8 pools alike: both sides dequantize to the same fp32
# values), 0.03 absolute with bf16 outputs (one bf16 rounding of a value
# of magnitude up to ~4).  bf16 outputs must also meet the slot kernel's
# tighter bar, FP32_TOL + BF16_ULP |plain|: both sides accumulate in fp32
# and round once to bf16, so they differ by at most one bf16 step.
PAGED_FP32_TOL = 1e-5
PAGED_BF16_TOL = 0.03
BLOCK = 16  # paged block size of the continuous runs

# phase 3's shapes for the other configs the port serves: head_dim 256 at
# G = 1, 2, 4, 8 (gemma2-9b: G = 2, its one-shot decode at B = 4, C = 576,
# and its prefill scores at B = 4, T = 4608), a score head dim between 128
# and 256 (192; the decode kernels take up to 128, and 256, and refuse
# 192: `check_head_dim_refusals`), and the (G, Dh) pairs of granite-3-2b
# (4, 64), qwen1.5-110b (8, 128), granite-moe-1b-a400m (2, 64) and
# qwen3-moe-30b-a3b (8, 128); and (phase 17) the groups that do not
# divide 8: G = 5 (hymba-1.5b, Dh 64: its decode shape B 8, S 16, C 576,
# and its prefill scores at B 8, T 2048, W*G = 160) and G = 7
# (llava-next-34b, Dh 128: B 2, S 16, C 576; scores at B 2, T 3904, W*G =
# 224), each also at the other head dim, with the split lengths to 1600
C_MAIN = int(round(ALPHA * BUDGET)) + MARGIN
FAMILY_DECODE_SHAPES = [  # (B, S, G, Dh, C)
    (4, 16, 2, 256, C_MAIN), (2, 5, 2, 256, 1600), (3, 4, 1, 256, 200), (2, 4, 4, 256, 96),
    (2, 3, 8, 256, 300), (4, 8, 4, 64, 200), (2, 8, 8, 128, 300),
    (4, 8, 2, 64, 150),
    (8, 16, 5, 64, C_MAIN), (2, 16, 7, 128, C_MAIN), (2, 5, 5, 128, 1600),
    (2, 5, 7, 64, 1600), (3, 4, 5, 64, 200), (2, 3, 7, 128, 96)]
FAMILY_SCORE_SHAPES = [  # (B, W, Hq, Hkv, Dh, T)
    (4, OBS, 16, 8, 256, 4608), (1, OBS, 16, 8, 256, 1000), (2, 8, 4, 4, 256, 200),
    (1, OBS, 64, 8, 256, 500), (1, 8, 8, 2, 192, 130), (1, OBS, 32, 8, 64, 1000),
    (1, OBS, 64, 8, 128, 1000), (1, OBS, 16, 8, 64, 500), (1, OBS, 32, 4, 128, 500),
    (8, OBS, 25, 5, 64, 2048), (2, OBS, 56, 8, 128, 3904), (1, OBS, 12, 12, 64, 256)]
FAMILY_PAGED_SHAPES = [  # (S, B, G, Dh, C, bs)
    (16, 4, 2, 256, C_MAIN, BLOCK), (3, 2, 1, 256, 96, 16), (4, 3, 4, 256, 200, 8),
    (2, 2, 8, 256, 64, 32), (4, 3, 4, 64, 150, 16),
    (3, 2, 8, 128, 120, 16), (3, 2, 2, 64, 90, 8),
    (16, 8, 5, 64, C_MAIN, BLOCK), (16, 2, 7, 128, C_MAIN, BLOCK), (3, 2, 5, 128, 120, 16),
    (4, 3, 7, 64, 150, 8)]
# groups the multi-query kernel is not built for: it must raise there
MQ_REFUSED_GROUPS = (5, 7)
FAMILY_MQ_SHAPES = [  # (S, B, G, Dh, C, bs)
    (3, 2, 2, 256, 200, 16), (2, 2, 8, 256, 64, 32), (3, 2, 1, 256, 96, 16),
    (2, 3, 4, 256, 100, 16)]
FAMILY_CONTRACT_SHAPES = [  # (S, B, G, Dh, C, bs, Qs)
    (3, 2, 2, 256, 200, 16, (1, 5, 9)), (2, 2, 8, 256, 64, 32, (5,)),
    (3, 2, 1, 256, 96, 16, (1, 5, 40)), (16, 4, 2, 256, C_MAIN, BLOCK, (5,)),
    (2, 2, 2, 128, 2 * 4096 + 300, 16, (5,))]  # past two of kernel 1's segments


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phase 1-2
# ---------------------------------------------------------------------------


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(report: str):
    """[(kernel function, registers, stack bytes, spill store bytes, spill
    load bytes)] from an ``nvcc -Xptxas -v`` report, names demangled with
    cu++filt where the toolkit has it."""
    import re
    import shutil
    rows, name, props = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, props = m.group(1), None
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            props = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1)), *(props or (0, 0, 0))))
            name = None
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    if rows and Path(filt).exists():
        out = subprocess.run([filt], input="\n".join(r[0] for r in rows), text=True,
                             capture_output=True, timeout=60).stdout.splitlines()
        if len(out) == len(rows):
            rows = [(_short_name(o), *r[1:]) for o, r in zip(out, rows)]
    return rows


def _short_name(demangled: str) -> str:
    """`void ns::(anonymous namespace)::kern<float, 4, true, float const*, ...>(float
    const*, ...)` -> `kern<float, 4, true>`."""
    name = demangled.replace("(anonymous namespace)::", "").replace("<unnamed>::", "")
    name = name.removeprefix("void ")
    end = name.find(">(")
    name = name[:end + 1] if end >= 0 else name.split("(")[0]
    head, lt, tail = name.partition("<")
    if lt:  # drop a trailing pack of parameter types: kern<float, 4, true, float const*, ...>
        args = tail[:-1].split(", ")
        n = next((i for i, a in enumerate(args) if "*" in a), len(args))
        tail = ", ".join(args[:n]) + ">"
    return head.split("::")[-1] + lt + tail


def build_kernels():
    """Build every kernel library (one nvcc per source, in parallel) and
    print the build time and, per kernel instantiation, ptxas's registers,
    stack and spill; fails if any instantiation spills or uses a stack."""
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    reports = build.build()
    dt = time.perf_counter() - t0
    log(f"[build] {len(reports)} kernel libraries built in {dt:.1f} s "
        f"(sources: {', '.join(build.KERNELS)})")
    for name, (_, secs) in reports.items():
        log(f"[build] {name}: linked {secs:.1f} s after the start, from "
            f"{len(build.SOURCES[name])} translation units compiled in parallel")
    bad = []
    for name, (rep, _) in reports.items():
        rows = ptxas_summary(rep)
        for fn, regs, stack, st, ld in rows:
            log(f"[ptxas {name}] {fn}: {regs} registers, {stack} B stack, "
                f"{st}/{ld} B spill stores/loads")
        if rows:
            log(f"[ptxas {name}] {len(rows)} instantiations: registers "
                f"{min(r[1] for r in rows)}-{max(r[1] for r in rows)}, max stack "
                f"{max(r[2] for r in rows)} B, max spill {max(r[3] + r[4] for r in rows)} B")
        bad += [(name, *r) for r in rows if r[2] or r[3] or r[4]]
    if bad:  # after every library's report, so one run shows them all
        fail(f"ptxas reports stack or spill in {len(bad)} instantiations: {bad}")
    for name in build.KERNELS:
        build.load(name)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------


def _cmp(name, out, ref, tol_abs, tol_rel=0.0):
    import torch
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    if not torch.isfinite(o).all():
        fail(f"{name}: non-finite kernel output")
    err = (o - r).abs()
    bound = tol_abs + tol_rel * r.abs()
    if not bool((err <= bound).all()):
        fail(f"{name}: max |kernel - plain| = {err.max().item():.3e} exceeds "
             f"{tol_abs:g} + {tol_rel:g}|plain|")
    return err.max().item()


def _cmp_paged(name, out, ref):
    """The paged kernel's bars (PAGED_*_TOL, one bf16 step); max abs err."""
    import torch
    if out.dtype == torch.float32:
        return _cmp(name, out, ref, PAGED_FP32_TOL)
    _cmp(name, out, ref, FP32_TOL, BF16_ULP)
    return _cmp(name, out, ref, PAGED_BF16_TOL)


def decode_inputs(gen, Bq, S, G, Dh, C, dtype, empty_slot=False, lengths=None):
    import torch
    dev = "cuda"
    q = torch.randn((Bq, S, G, Dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((S, Bq, C, Dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((S, Bq, C, Dh), generator=gen, device=dev).to(dtype)
    if lengths is None:
        lengths = torch.randint(0 if empty_slot else 1, C + 1, (S, Bq),
                                generator=gen, device=dev, dtype=torch.int32)
    if empty_slot:
        lengths[0] = 0
    k_pos = torch.arange(C, dtype=torch.int32, device=dev).expand(S, Bq, C).contiguous()
    q_pos = torch.full((Bq,), C + 7, dtype=torch.int32, device=dev)
    return q, k, v, lengths, k_pos, q_pos


# (slot, row) lengths from one entry to C = 1600: partial and whole groups
# of 8 column classes, one to 13 ring stages of the slot kernel's blocks
SPLIT_LENGTHS = (1, 7, 32, 33, 128, 129, 577, 1000, 1599, 1600)


def check_decode(gen):
    """fairkv_decode against fairkv_decode_ref (tolerance below) and, on
    every case, bitwise against paged_fairkv_decode_cuda over the same
    cache laid out as pools with an identity block table."""
    import torch
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.kernels.ref import fairkv_decode_ref
    from repro_torch.paging.testing import slot_layer_as_pool
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(4, 8, 8, 64, 256), (2, 16, 1, 128, 200), (3, 5, 4, 32, 96),
              (1, 16, 8, 128, 1600), (2, 4, 2, 16, 64),
              (B, N_SHARDS * SLOTS_PER_SHARD, 4, 128, C_main), (2, 5, 4, 128, 1600)]
    shapes += FAMILY_DECODE_SHAPES
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        # bf16: both sides compute in fp32 from the same bf16 values and
        # round once to bf16, so they may differ by one bf16 step
        tol_rel = 0.0 if dtype == torch.float32 else BF16_ULP
        for (Bq, S, G, Dh, C) in shapes:
            lengths = None
            if C == 1600 and S * Bq == len(SPLIT_LENGTHS):
                lengths = torch.tensor(SPLIT_LENGTHS, dtype=torch.int32,
                                       device="cuda").reshape(S, Bq)
            for window, cap, empty in ((0, 0.0, False), (0, 0.0, True),
                                       (C // 3, 0.0, False), (0, 50.0, True)):
                ln_in = None if lengths is None else lengths.clone()
                q, k, v, ln, kp, qp = decode_inputs(gen, Bq, S, G, Dh, C, dtype, empty,
                                                    lengths=ln_in)
                out = fairkv_decode_cuda(q, k, v, ln, cap, k_pos=kp, q_pos=qp,
                                         window=window)
                ref = fairkv_decode_ref(q, k, v, ln, cap, k_pos=kp, q_pos=qp,
                                        window=window)
                tag = f"fairkv_decode {dtype} {(Bq, S, G, Dh, C)} w={window} cap={cap}"
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, tol_rel))
                if empty and out[:, 0].abs().max().item() != 0.0:
                    fail(f"{tag}: the all-zero slot's output is not exactly 0")
                kpool, vpool, ppool, tbl = slot_layer_as_pool(k, v, kp, BLOCK)
                paged = paged_fairkv_decode_cuda(q, kpool, vpool, ppool, tbl, ln, C, cap,
                                                 q_pos=qp, window=window)
                if not torch.equal(out, paged):
                    d = (out.float() - paged.float()).abs().max().item()
                    fail(f"{tag}: differs from paged_fairkv_decode_cuda over an identity "
                         f"block table (max |diff| {d:.3e}); the two must agree bitwise")
                n += 1
    log(f"[check] fairkv_decode: {n} cases vs plain, max abs err {worst:.3e} "
        f"(tol {FP32_TOL:g} fp32; + one bf16 step {BF16_ULP:g}|plain| for bf16); "
        f"all {n} bitwise equal to paged_fairkv_decode_cuda over an identity block table "
        f"(lengths 1 to 1600)")


SEG_WINDOW = 5000  # keeps positions > C + 7 - 5000: masks the first segment whole


def seg_lengths(seg):
    """(slot, row) lengths past kernel 1's segments (``seg`` columns each)
    in a cache of 3 seg + 100 columns: one column, one whole segment, one
    column into the second, a partial third and fourth segment, and 1000
    (the segments after it empty)."""
    return (1, seg, seg + 1, 2 * seg + 37, 3 * seg + 100, 1000)


def check_decode_segments(gen):
    """Kernel 1 past one segment: against its plain version (fp32 and bf16)
    at G 1, 2, 4, 5, 7, 8 and Dh 64, 128, 256 over `seg_lengths`, plain and
    with a window that masks whole segments and softcap; the partial
    variant's o and lse (empty pairs o = 0, lse = -inf exactly); slot ≡
    paged bitwise at every G and Dh, and ≡ multi-query (Q = 1) but at G 5
    and 7, at lengths past two segments, over an identity table with block
    sizes 16 and 48 (a table block across a segment's edge); two launches bitwise equal with the counters left at 0;
    one graph replay at the long shape equal to eager."""
    import torch
    from repro_torch.kernels import fairkv_decode as K1
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    from repro_torch.kernels.ref import fairkv_decode_partial_ref, fairkv_decode_ref
    from repro_torch.paging.testing import slot_layer_as_pool
    seg = K1.SEG
    lengths = seg_lengths(seg)
    C = max(lengths)
    S, Bq = 3, 2
    ln0 = torch.tensor(lengths, dtype=torch.int32, device="cuda").reshape(S, Bq)
    t0 = time.perf_counter()
    worst = 0.0
    n = n_part = n_bit = n_mq = 0
    for dtype in (torch.float32, torch.bfloat16):
        tol_rel = 0.0 if dtype == torch.float32 else BF16_ULP
        for G, Dh in itertools.product(K1.GROUP_SIZES, (64, 128, 256)):
            q, k, v, ln, kp, qp = decode_inputs(gen, Bq, S, G, Dh, C, dtype,
                                                lengths=ln0.clone())
            for window, cap in ((0, 0.0), (SEG_WINDOW, 50.0)):
                kw = dict(k_pos=kp, q_pos=qp, window=window)
                tag = f"fairkv_decode segments {dtype} {(Bq, S, G, Dh, C)} w={window} cap={cap}"
                out = K1.fairkv_decode_cuda(q, k, v, ln, cap, **kw)
                worst = max(worst, _cmp(tag, out, fairkv_decode_ref(q, k, v, ln, cap, **kw),
                                        FP32_TOL, tol_rel))
                n += 1
                if (G, Dh) in ((2, 256), (5, 64), (8, 128)):
                    o, lse = K1.fairkv_decode_partial_cuda(q, k, v, ln, cap, **kw)
                    o_ref, lse_ref = fairkv_decode_partial_ref(q, k, v, ln, cap, **kw)
                    torch.cuda.synchronize()
                    empty = torch.isinf(lse_ref)
                    if not (torch.equal(torch.isinf(lse), empty)
                            and bool((o[empty] == 0).all())):
                        fail(f"{tag} partial: empty pairs not o = 0, lse = -inf")
                    worst = max(worst, _cmp(tag + " partial", o, o_ref, FP32_TOL, 1e-5),
                                _cmp(tag + " partial lse", torch.where(empty, 0.0, lse),
                                     torch.where(empty, 0.0, lse_ref), FP32_TOL, 1e-5))
                    n_part += 1
                if dtype == torch.bfloat16:
                    for bs in (BLOCK, 48):
                        kpool, vpool, ppool, tbl = slot_layer_as_pool(k, v, kp, bs)
                        pargs = (kpool, vpool, ppool, tbl, ln, C, cap)
                        paged = paged_fairkv_decode_cuda(q, *pargs, q_pos=qp, window=window)
                        if not torch.equal(out, paged):
                            fail(f"{tag} bs={bs}: the slot and paged kernels differ; they "
                                 f"must agree bitwise")
                        n_bit += 1
                        if G in (5, 7):  # the multi-query kernel refuses them
                            continue
                        mq = paged_fairkv_decode_mq_cuda(q[:, :, None].contiguous(), *pargs,
                                                         q_pos=qp, window=window)[:, :, 0]
                        if not torch.equal(out, mq):
                            fail(f"{tag} bs={bs}: the multi-query (Q = 1) kernel differs from "
                                 f"the slot and paged kernels; the three must agree bitwise")
                        n_mq += 1
    # two launches bitwise equal, the arrival counters left at 0, and one
    # graph replay equal to eager, at the long shape (bf16, G 2, Dh 256)
    q, k, v, ln, kp, qp = decode_inputs(gen, Bq, S, 2, 256, C, torch.bfloat16,
                                        lengths=ln0.clone())
    a = K1.fairkv_decode_cuda(q, k, v, ln, 50.0)
    b = K1.fairkv_decode_cuda(q, k, v, ln, 50.0)
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail("fairkv_decode segments: two launches on the same inputs differ")
    if any(int(c.abs().sum()) for c in K1._COUNTERS.values()):
        fail("fairkv_decode segments: the arrival counters are not 0 after the launches")
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K1.fairkv_decode_cuda(q, k, v, ln, 50.0)
        with torch.cuda.graph(graph, stream=side):
            g_out = K1.fairkv_decode_cuda(q, k, v, ln, 50.0)
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    if not torch.equal(g_out, a):
        fail("fairkv_decode segments: a graph replay differs from the eager launch")
    del graph
    log(f"[check] fairkv_decode past one segment ({seg} columns; C {C}, lengths {lengths}): "
        f"{n} cases vs plain (G {K1.GROUP_SIZES}, Dh 64/128/256, fp32 and bf16, a window of "
        f"{SEG_WINDOW} masking whole segments with softcap 50), {n_part} of the partial "
        f"variant (o and lse), max abs err {worst:.3e}; {n_bit} cases slot ≡ paged bitwise, "
        f"{n_mq} of them ≡ multi-query (Q = 1) too (block sizes {BLOCK} and 48); two launches "
        f"bitwise equal, counters 0; a graph replay equal to eager; {time.perf_counter() - t0:.1f} s")


def check_head_dim_refusals(gen):
    """Head dims the kernels are not built for raise on the card (the
    decode kernels: 192 and 320; the score kernel: 320), and so does the
    multi-query kernel at G = 5 and 7; nothing falls back to a plain
    version."""
    import torch
    from repro_torch.kernels import ops
    n = 0
    for Dh in (192, 320):
        q = torch.randn((2, 4, 2, Dh), generator=gen, device="cuda")
        k = torch.randn((4, 2, 16, Dh), generator=gen, device="cuda")
        ln = torch.full((4, 2), 8, dtype=torch.int32, device="cuda")
        kp = torch.randn((5, 8, Dh), generator=gen, device="cuda")
        pp = torch.zeros((5, 8), dtype=torch.int32, device="cuda")
        tbl = torch.ones((4, 2, 2), dtype=torch.int32, device="cuda")
        pos = torch.arange(16, dtype=torch.int32, device="cuda")[None]
        calls = [("fairkv_decode", lambda: ops.fairkv_decode(q, k, k, ln)),
                 ("paged_fairkv_decode", lambda: ops.paged_fairkv_decode(q, kp, kp, pp, tbl,
                                                                          ln, 16)),
                 ("paged_fairkv_decode_mq", lambda: ops.paged_fairkv_decode(
                     q[:, :, None].contiguous(), kp, kp, pp, tbl, ln, 16))]
        if Dh > 256:
            qo = torch.randn((1, 4, 2, Dh), generator=gen, device="cuda")
            ko = torch.randn((1, 16, 1, Dh), generator=gen, device="cuda")
            calls.append(("snapkv_scores", lambda: ops.snapkv_scores(
                qo, ko, pos[:, -4:].contiguous(), pos)))
        for name, call in calls:
            try:
                call()
            except ValueError as e:
                if "head_dim" not in str(e):
                    raise
                n += 1
            else:
                fail(f"{name}: head_dim {Dh} was accepted")
    for G in MQ_REFUSED_GROUPS:  # the multi-query kernel is not built for G = 5, 7
        q = torch.randn((2, 4, 3, G, 64), generator=gen, device="cuda")
        kp = torch.randn((5, 8, 64), generator=gen, device="cuda")
        pp = torch.zeros((5, 8), dtype=torch.int32, device="cuda")
        tbl = torch.ones((4, 2, 2), dtype=torch.int32, device="cuda")
        ln = torch.full((4, 2), 8, dtype=torch.int32, device="cuda")
        try:
            ops.paged_fairkv_decode(q, kp, kp, pp, tbl, ln, 16)
        except ValueError as e:
            if f"G={G}" not in str(e):
                raise
            n += 1
        else:
            fail(f"paged_fairkv_decode_mq: G = {G} was accepted")
    log(f"[check] {n} calls at head dims the kernels are not built for (192, 320), and "
        f"the multi-query kernel at G {MQ_REFUSED_GROUPS}, raised")


def scores_inputs(gen, Bq, W, Hq, Hkv, Dh, Tk, dtype):
    import torch
    dev = "cuda"
    q = torch.randn((Bq, W, Hq, Dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((Bq, Tk, Hkv, Dh), generator=gen, device=dev).to(dtype)
    kpos = torch.arange(Tk, dtype=torch.int32, device=dev).expand(Bq, Tk).contiguous()
    opos = torch.arange(Tk - W, Tk, dtype=torch.int32, device=dev).expand(Bq, W).contiguous()
    return q, k, opos, kpos


def check_scores(gen):
    import torch
    from repro_torch.kernels.ref import snapkv_scores_ref
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    # the main shape; B = 1 (the continuous scheduler's admission prefills)
    # with T tails that are not multiples of the 64-key tile; G = 1, 2, 8
    # at W = 32 (R = 32 ... 256 query rows); Dh 32, 64, 128
    shapes = [(2, 8, 8, 2, 64, 256), (1, 4, 4, 4, 32, 100), (2, 16, 8, 8, 64, 128),
              (B, OBS, 32, 8, 128, T)]
    shapes += [(1, OBS, 32, 8, 128, Tk) for Tk in (63, 1000, 2047, 2048)]
    shapes += [(1, OBS, 8 * G, 8, 128, 1000) for G in (1, 2, 8)]
    shapes += FAMILY_SCORE_SHAPES
    worst = 0.0
    n = 0
    for dtype in (torch.float32, torch.bfloat16):
        for (Bq, W, Hq, Hkv, Dh, Tk) in shapes:
            for cap in (0.0, 50.0):
                q, k, opos, kpos = scores_inputs(gen, Bq, W, Hq, Hkv, Dh, Tk, dtype)
                out = snapkv_scores_cuda(q, k, opos, kpos, cap)
                ref = snapkv_scores_ref(q, k, opos, kpos, cap)
                tag = f"snapkv_scores {dtype} {(Bq, W, Hq, Hkv, Dh, Tk)} cap={cap}"
                # fp32 outputs from identical inputs: only the order of the
                # exp sums differs; entries are sums of up to W*G probabilities
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, 1e-5))
                mass = out.sum(dim=-1)
                G = Hq // Hkv
                if not torch.allclose(mass, torch.full_like(mass, W * G), rtol=1e-4):
                    fail(f"{tag}: mass per (b, h) is not W*G = {W * G}")
                n += 1
    log(f"[check] snapkv_scores: {n} cases vs plain, max abs err {worst:.3e} "
        f"(tol {FP32_TOL:g} + 1e-5|plain|), mass W*G per (b, h) conserved")
    check_scores_chunk(gen)


def chunk_scores_inputs(gen, W, Hq, Hkv, Dh, Ck, start, valid, dtype):
    """Kernel 2's inputs at the chunked-prefill shape, as `_chunk_attention`
    builds them: B = 1, the chunk's Ck keys at absolute positions
    start .. start + Ck - 1 (keys past ``valid`` are the padding of a last
    chunk), and the last min(W, Ck) valid queries (indices clipped at 0,
    so a chunk with fewer than W valid tokens repeats its first query)."""
    import torch
    q_all = torch.randn((1, Ck, Hq, Dh), generator=gen, device="cuda").to(dtype)
    k = torch.randn((1, Ck, Hkv, Dh), generator=gen, device="cuda").to(dtype)
    kpos = (start + torch.arange(Ck, dtype=torch.int32, device="cuda"))[None].contiguous()
    ix = torch.clamp(valid - W + torch.arange(W, device="cuda"), 0, Ck - 1)
    return q_all[:, ix].contiguous(), k, kpos[:, ix].contiguous(), kpos


def check_scores_chunk(gen):
    """Kernel 2 at the chunked-prefill shape (B = 1, W = OBS queries, Ck =
    CHUNK keys at positions from ``start``): full chunks at start 0 and
    1024, a padded last chunk (valid 300 < Ck) and one with fewer valid
    tokens than W (valid 20); against the plain version (tolerance as in
    `check_scores`), the W*G mass kept, and the padding keys scored
    exactly 0 (every query precedes them)."""
    import torch
    from repro_torch.kernels.ref import snapkv_scores_ref
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    worst, n = 0.0, 0
    for dtype in (torch.float32, torch.bfloat16):
        for start, valid in ((0, CHUNK), (1024, CHUNK), (1024, 300), (1536, 20)):
            for cap in (0.0, 50.0):
                q, k, opos, kpos = chunk_scores_inputs(gen, OBS, 32, 8, 128, CHUNK, start,
                                                       valid, dtype)
                out = snapkv_scores_cuda(q, k, opos, kpos, cap)
                ref = snapkv_scores_ref(q, k, opos, kpos, cap)
                tag = f"snapkv_scores chunk {dtype} start={start} valid={valid} cap={cap}"
                worst = max(worst, _cmp(tag, out, ref, FP32_TOL, 1e-5))
                mass = out.sum(dim=-1)
                if not torch.allclose(mass, torch.full_like(mass, OBS * 4), rtol=1e-4):
                    fail(f"{tag}: mass per (b, h) is not W*G = {OBS * 4}")
                if valid < CHUNK and bool((out[..., valid:] != 0).any()):
                    fail(f"{tag}: padding keys past valid scored non-zero")
                n += 1
    log(f"[check] snapkv_scores at the chunk shape (B=1, W={OBS}, Hq=32, Hkv=8, Dh=128, "
        f"T={CHUNK}, start 0 / 1024 / 1536, valid {CHUNK} / 300 / 20): {n} cases vs plain, "
        f"max abs err {worst:.3e} (tol {FP32_TOL:g} + 1e-5|plain|), mass W*G conserved, "
        f"padding keys exactly 0")


def check_paged():
    """paged_fairkv_decode against paged_fairkv_decode_ref on the card:
    bf16 / fp32 pools, int8, fp8 and mixed kinds (fp32 and bf16 queries),
    G in {1, 2, 4, 8}, ragged lengths with empty (all-null) table rows,
    partial last blocks, an all-zero-length layer, window + softcap, fp8
    NaN codes inside the valid range (read as 0 by both), and the main
    path's shape (S=16, B=8, G=4, Dh=128, C=576, bs=16)."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.kernels.ref import paged_fairkv_decode_ref
    rng = np.random.default_rng(SEED)
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(3, 2, 1, 64, 96, 16), (4, 3, 2, 32, 200, 8), (2, 2, 8, 64, 256, 32),
              (3, 2, 4, 128, 100, 64), (N_SHARDS * SLOTS_PER_SHARD, B, 4, 128, C_main, BLOCK)]
    shapes += FAMILY_PAGED_SHAPES
    worst = {}  # (pools, output dtype) -> max abs err
    n = 0
    for (S, Bq, G, Dh, C, bs) in shapes:
        for window, cap in ((0, 0.0), (C // 3, 0.0), (0, 30.0), (C // 2, 30.0)):
            for mode in ("fp32", "bf16", "int8", "fp8", "mixed"):
                for q_dt in ((torch.float32, torch.bfloat16) if mode in ("int8", "fp8", "mixed")
                             else (torch.float32 if mode == "fp32" else torch.bfloat16,)):
                    lengths = np.zeros((S, Bq), np.int32) if n % 17 == 5 else None
                    kp, vp, pp, tbl, ln, qkw = _paged_case(rng, mode, S, Bq, C, bs, Dh,
                                                           lengths)
                    q = torch.from_numpy(rng.normal(size=(Bq, S, G, Dh)).astype(np.float32)
                                         ).to("cuda", q_dt)
                    qpos = torch.full((Bq,), C + 7, dtype=torch.int32, device="cuda")
                    out = paged_fairkv_decode_cuda(q, kp, vp, pp, tbl, ln, C, cap,
                                                   q_pos=qpos, window=window, **qkw)
                    ref = paged_fairkv_decode_ref(q, kp, vp, pp, tbl, ln, C, cap,
                                                  q_pos=qpos, window=window, **qkw)
                    tag = (f"paged_fairkv_decode {mode} q={q_dt} {(S, Bq, G, Dh, C, bs)} "
                           f"w={window} cap={cap}")
                    key = (mode, str(q_dt).replace("torch.", ""))
                    worst[key] = max(worst.get(key, 0.0), _cmp_paged(tag, out, ref))
                    empty = (ln == 0).T  # (B, S)
                    if bool(empty.any()) and out[empty].abs().max().item() != 0.0:
                        fail(f"{tag}: a (slot, row) of length 0 is not exactly 0")
                    n += 1
    log(f"[check] paged_fairkv_decode: {n} cases vs plain (tol {PAGED_FP32_TOL:g} with "
        f"fp32 outputs; {PAGED_BF16_TOL:g} and {FP32_TOL:g} + {BF16_ULP:g}|plain| with "
        f"bf16); max abs err by (pools, q): "
        + ", ".join(f"{p}/{q} {e:.3e}" for (p, q), e in sorted(worst.items())))


def _paged_case(rng, mode, S, Bq, C, bs, Dh, lengths=None):
    """One layer for the paged kernels' checks: (k, v, pos, table, lengths,
    quantization kwargs); int8 / fp8 / mixed pools get fp8 NaN codes
    planted in valid columns of their fp8 slots (both sides read 0)."""
    import numpy as np
    import torch
    from repro_torch.paging.testing import make_paged_layer, quantize_paged_layer
    pool_dt = torch.bfloat16 if mode == "bf16" else torch.float32
    kp, vp, pp, tbl, ln = make_paged_layer(rng, S, Bq, C, bs, Dh, dtype=pool_dt,
                                           lengths=lengths, device="cuda")
    kw = {}
    if mode in ("int8", "fp8", "mixed"):
        kinds = {"int8": np.zeros(S), "fp8": np.ones(S),
                 "mixed": np.arange(S) % 2}[mode].astype(np.int32)
        kinds = torch.from_numpy(kinds).to("cuda")
        kp, vp, ks, vs = quantize_paged_layer(kp, vp, tbl, kinds)
        if mode != "int8":
            fp8_blocks = tbl[kinds.bool()][..., 0]
            fp8_blocks = fp8_blocks[fp8_blocks > 0]
            kp[fp8_blocks, 0, :4] = 0x7F
            vp[fp8_blocks, 0, 4:8] = -1  # 0xFF
        kw = dict(k_scale=ks, v_scale=vs, kinds=kinds)
    return kp, vp, pp, tbl, ln, kw


def check_paged_mq():
    """paged_fairkv_decode_mq against paged_fairkv_decode_ref with a 5-D q
    on the card: Q in {1, 3, 5} with ragged q_lens (garbage lanes past
    them), G in {1, 4, 8}, fp32 / bf16 / int8 / fp8 / mixed pools (fp32 and
    bf16 queries on the quantized ones), ragged lengths with empty pairs
    and lengths under the window (queries with no visible entry), null
    tables, partial last blocks, window + softcap, and the full-width shape
    (S=16, B=8, G=4, Dh=128, C=576, bs=16).  Tolerance: fp32 outputs within
    FP32_TOL, bf16 outputs within one bf16 step (FP32_TOL + BF16_ULP|plain|).
    At Q = 1 the kernel must equal `paged_fairkv_decode_cuda` bitwise."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    from repro_torch.kernels.ref import paged_fairkv_decode_ref
    rng = np.random.default_rng(SEED + 2)
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(3, 2, 1, 64, 96, 16), (4, 3, 4, 32, 200, 8), (2, 2, 8, 64, 64, 32),
              (N_SHARDS * SLOTS_PER_SHARD, B, 4, 128, C_main, BLOCK)]
    shapes += FAMILY_MQ_SHAPES
    worst, n, n_bitwise = {}, 0, 0
    for (S, Bq, G, Dh, C, bs) in shapes:
        for Q in (1, 3, 5):
            for window, cap in ((0, 0.0), (C // 3, 30.0)):
                for mode in ("fp32", "bf16", "int8", "fp8", "mixed"):
                    for q_dt in ((torch.float32, torch.bfloat16)
                                 if mode in ("int8", "fp8", "mixed")
                                 else (torch.float32 if mode == "fp32" else torch.bfloat16,)):
                        lengths = np.zeros((S, Bq), np.int32) if n % 23 == 7 else None
                        kp, vp, pp, tbl, ln, kw = _paged_case(rng, mode, S, Bq, C, bs, Dh,
                                                              lengths)
                        q = torch.from_numpy(rng.normal(size=(Bq, S, Q, G, Dh)).astype(
                            np.float32)).to("cuda", q_dt)
                        q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=Bq).astype(
                            np.int32)).to("cuda")
                        qpos = torch.full((Bq,), C + 7, dtype=torch.int32, device="cuda")
                        args = (q, kp, vp, pp, tbl, ln, C, cap)
                        out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window,
                                                          q_lens=q_lens, **kw)
                        ref = paged_fairkv_decode_ref(*args, q_pos=qpos, window=window,
                                                      q_lens=q_lens, **kw)
                        tag = (f"paged_fairkv_decode_mq {mode} q={q_dt} Q={Q} "
                               f"{(S, Bq, G, Dh, C, bs)} w={window} cap={cap}")
                        rel = 0.0 if q_dt == torch.float32 else BF16_ULP
                        key = (mode, str(q_dt).replace("torch.", ""))
                        worst[key] = max(worst.get(key, 0.0), _cmp(tag, out, ref, FP32_TOL, rel))
                        lnT = ln.T[:, :, None].long()  # (B, S, 1)
                        limit = torch.minimum(lnT - (q_lens.long()[:, None, None] - 1
                                                     - torch.arange(Q, device="cuda")), lnT)
                        dead = limit <= 0  # queries that see no entry
                        if bool(dead.any()) and out[dead].abs().max().item() != 0.0:
                            fail(f"{tag}: a query with no visible entry is not exactly 0")
                        if Q == 1:
                            single = paged_fairkv_decode_cuda(q[:, :, 0].contiguous(), kp, vp,
                                                              pp, tbl, ln, C, cap, q_pos=qpos,
                                                              window=window, **kw)
                            if not torch.equal(single, out[:, :, 0]):
                                fail(f"{tag}: Q = 1 differs from paged_fairkv_decode_cuda")
                            n_bitwise += 1
                        n += 1
    log(f"[check] paged_fairkv_decode_mq: {n} cases vs plain (tol {FP32_TOL:g} with fp32 "
        f"outputs, {FP32_TOL:g} + {BF16_ULP:g}|plain| with bf16); {n_bitwise} Q = 1 cases "
        f"bitwise equal to paged_fairkv_decode_cuda; max abs err by (pools, q): "
        + ", ".join(f"{p}/{q} {e:.3e}" for (p, q), e in sorted(worst.items())))


def _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window, q_lens, kw):
    """paged_fairkv_decode_cuda once per query i of a 5-D q, at the query's
    causal lengths and q_pos + i: what the multi-query kernel's query i
    must equal bitwise."""
    import torch
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.paging.testing import query_lengths
    return torch.stack([paged_fairkv_decode_cuda(q[:, :, i].contiguous(), kp, vp, pp, tbl,
                                                 query_lengths(ln, q_lens, i), C, cap,
                                                 q_pos=qpos + i, window=window, **kw)
                        for i in range(q.shape[2])], dim=2)


def check_paged_contracts():
    """The bitwise contracts of the paged kernels on the card, with zero
    mismatches allowed:

    - query i of paged_fairkv_decode_mq equals paged_fairkv_decode at
      lengths min(len - (qn - 1 - i), len) clamped at 0 and q_pos + i, for
      fp32 / bf16 / int8 / fp8 / mixed pools, with and without window and
      softcap, at Q from 1 to 40 (queries split into chunks: G = 1 at
      Q = 9 and 40, G = 2 at Q = 7) and at the main path's shape;
    - both kernels on pools whose blocks are relabelled, through the
      remapped table, equal their output on the original layer."""
    import numpy as np
    import torch
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    from repro_torch.paging.testing import relabel_pool_blocks
    rng = np.random.default_rng(SEED + 3)
    C_main = int(round(ALPHA * BUDGET)) + MARGIN
    shapes = [(3, 2, 1, 64, 96, 16, (1, 5, 9, 40)), (4, 3, 4, 32, 200, 8, (3, 5)),
              (2, 2, 8, 64, 64, 32, (5,)), (2, 3, 2, 128, 300, 16, (7,)),
              (N_SHARDS * SLOTS_PER_SHARD, B, 4, 128, C_main, BLOCK, (5,))]
    shapes += FAMILY_CONTRACT_SHAPES
    n_query = n_perm = 0
    for (S, Bq, G, Dh, C, bs, Qs) in shapes:
        for mode in ("fp32", "bf16", "int8", "fp8", "mixed"):
            for window, cap in ((0, 0.0), (C // 3, 30.0)):
                q_dt = (torch.bfloat16 if mode == "bf16" or (mode != "fp32" and window)
                        else torch.float32)
                kp, vp, pp, tbl, ln, kw = _paged_case(rng, mode, S, Bq, C, bs, Dh)
                qpos = torch.full((Bq,), C + 7, dtype=torch.int32, device="cuda")
                perm = None
                for Q in Qs:
                    tag = (f"paged contracts {mode} q={q_dt} Q={Q} {(S, Bq, G, Dh, C, bs)} "
                           f"w={window} cap={cap}")
                    q = torch.from_numpy(rng.normal(size=(Bq, S, Q, G, Dh)).astype(
                        np.float32)).to("cuda", q_dt)
                    q_lens = torch.from_numpy(rng.integers(1, Q + 1, size=Bq).astype(
                        np.int32)).to("cuda")
                    q_lens[0] = Q
                    args = (q, kp, vp, pp, tbl, ln, C, cap)
                    out = paged_fairkv_decode_mq_cuda(*args, q_pos=qpos, window=window,
                                                      q_lens=q_lens, **kw)
                    single = _single_per_query(q, kp, vp, pp, tbl, ln, C, cap, qpos, window,
                                               q_lens, kw)
                    torch.cuda.synchronize()
                    if not torch.equal(out, single):
                        bad = (out != single).flatten(3).any(-1).nonzero()[0].tolist()
                        fail(f"{tag}: query {bad[2]} of (b, s) = {tuple(bad[:2])} differs from "
                             f"paged_fairkv_decode at its causal length and position")
                    n_query += 1
                    if Q in (1, 5) and mode in ("fp32", "bf16", "int8", "mixed"):
                        if perm is None:
                            keys = [k for k in ("k_scale", "v_scale") if k in kw]
                            *layer, scales = relabel_pool_blocks(
                                kp, vp, pp, tbl, [kw[k] for k in keys], seed=SEED + n_perm)
                            perm = (*layer, dict(kw, **dict(zip(keys, scales))))
                        kp2, vp2, pp2, tbl2, kw2 = perm
                        out2 = paged_fairkv_decode_mq_cuda(q, kp2, vp2, pp2, tbl2, ln, C, cap,
                                                           q_pos=qpos, window=window,
                                                           q_lens=q_lens, **kw2)
                        q3 = q[:, :, -1].contiguous()
                        one = paged_fairkv_decode_cuda(q3, kp, vp, pp, tbl, ln, C, cap,
                                                       q_pos=qpos, window=window, **kw)
                        one2 = paged_fairkv_decode_cuda(q3, kp2, vp2, pp2, tbl2, ln, C, cap,
                                                        q_pos=qpos, window=window, **kw2)
                        torch.cuda.synchronize()
                        if not (torch.equal(out, out2) and torch.equal(one, one2)):
                            fail(f"{tag}: the kernels differ on relabelled pool blocks")
                        n_perm += 1
    log(f"[check] paged contracts: {n_query} multi-query cases, every query bitwise equal to "
        f"paged_fairkv_decode at its causal length and position (Q 1 to 40, G 1 to 8, all pool "
        f"kinds, window and softcap); {n_perm} cases of both kernels bitwise unchanged on "
        f"relabelled pool blocks")


# ---------------------------------------------------------------------------
# phase 4: CUDA port vs CPU port at smoke size
# ---------------------------------------------------------------------------


def smoke_parity():
    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
    rng = np.random.default_rng(SEED)
    toks = rng.integers(0, 256, size=(2, 96)).astype(np.int32)
    res = {}
    for dev in ("cpu", "cuda"):
        cfg = EngineConfig.smoke(
            ARCH, n_shards=8, device=dev,
            compression=CompressionConfig(policy="ada_snapkv", budget=24,
                                          alpha_max=2.0, obs_window=8, sink=2,
                                          decode_margin=8),
            planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=2))
        params = None
        if dev == "cuda":
            params = interop.to_torch(interop.to_numpy(res["cpu_params"]), "cuda")
        eng = Engine.build(cfg, params=params)
        res[dev] = eng.generate(toks, 8)
        if dev == "cpu":
            res["cpu_params"] = eng.params
    a, b = res["cpu"], res["cuda"]
    d = float(np.abs(a.logits - b.logits).max())
    # fp32 both sides; the card sums in another order than the CPU
    if not (np.array_equal(a.tokens, b.tokens) and np.array_equal(a.lengths, b.lengths)
            and d < 1e-3):
        fail(f"smoke parity: tokens equal {np.array_equal(a.tokens, b.tokens)}, "
             f"lengths equal {np.array_equal(a.lengths, b.lengths)}, max |dlogits| {d:.3e}")
    log(f"[smoke] {ARCH} smoke, fairkv_dp: CUDA port == CPU port tokens and "
        f"lengths; max |logits diff| {d:.3e} (tol 1e-3, fp32)")
    del res
    gc.collect()
    torch.cuda.empty_cache()


def smoke_spec_parity():
    """Speculative `run_trace` on paged fp32 pools at smoke size (the
    reference's speculative-test setup: no compression, block size 8, 4
    rows), full-depth and 1-layer drafts: on the card each gives the plain
    paged run's tokens and the same spec run's tokens on the CPU; the mq
    kernel carries every verify (n_layers launches per tick), the paged
    kernel every draft step (draft layers x max_k per tick)."""
    from repro_torch import interop
    from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                                 PlannerConfig, SchedulerConfig, SpeculationConfig,
                                 synthesize_requests)
    rows, max_k = 4, 3
    params = {}
    tokens = {}
    for dev in ("cpu", "cuda"):
        for name, spec in (("plain", SpeculationConfig()),
                           ("full draft", SpeculationConfig(enabled=True, max_k=max_k)),
                           ("1-layer draft", SpeculationConfig(enabled=True, max_k=max_k,
                                                               draft_layers=1))):
            cfg = EngineConfig.smoke(
                ARCH, n_shards=4, max_seq_len=38, device=dev,
                compression=CompressionConfig(policy="none", budget=64, capacity=64,
                                              alpha_max=1.0, obs_window=8, sink=2,
                                              decode_margin=8),
                planner=PlannerConfig(mode="fairkv_dp", extra_copies=6, batch_cap=rows),
                scheduler=SchedulerConfig(max_rows=rows, enable_replan=False),
                cache_backend="paged", paging=PagingConfig(block_size=8),
                speculation=spec)
            if "cpu" not in params:
                params["cpu"] = Engine.build(cfg).params
                params["cuda"] = interop.to_torch(interop.to_numpy(params["cpu"]), "cuda")
            eng = Engine.build(cfg, params=params[dev])
            reqs = synthesize_requests(6, 0.5, cfg.model.vocab_size, min_prompt=8,
                                       max_prompt=20, max_new_tokens=10, seed=3)
            out, got = _count(lambda: eng.run_trace(reqs, max_steps=400))
            if out["finished"] != 6 or eng.scheduler.backend.pool.blocks_in_use() != 0:
                fail(f"smoke spec {name} on {dev}: {out['finished']}/6 finished, "
                     f"{eng.scheduler.backend.pool.blocks_in_use()} blocks left")
            tokens[dev, name] = [r.generated for r in reqs]
            if dev == "cuda" and spec.enabled:
                nL, ticks = cfg.model.n_layers, out["decode_ticks"]
                d = spec.draft_layers or nL
                if (got["paged_fairkv_decode_mq"] != nL * ticks
                        or got["paged_fairkv_decode"] != d * max_k * ticks):
                    fail(f"smoke spec {name}: launches {got}, expected mq {nL} x {ticks}, "
                         f"paged {d} x {max_k} x {ticks}")
            log(f"[smoke] spec {dev:4s} {name:13s}: {out['decode_ticks']} ticks, "
                f"acceptance {out['acceptance']}")
    for name in ("full draft", "1-layer draft"):
        if tokens["cuda", name] != tokens["cuda", "plain"]:
            fail(f"smoke spec {name}: card tokens differ from the card's plain paged run")
        if tokens["cuda", name] != tokens["cpu", name]:
            fail(f"smoke spec {name}: card tokens differ from the CPU spec run")
    log("[smoke] speculative run_trace (full and 1-layer drafts): card tokens == card plain "
        "paged tokens == CPU spec tokens (fp32)")


# ---------------------------------------------------------------------------
# phase 5: the main path at full width
# ---------------------------------------------------------------------------


def planner(mode, ch):
    from repro_torch.api import PlannerConfig
    return PlannerConfig(mode=mode, extra_copies=ch, slots_per_shard=SLOTS_PER_SHARD,
                         batch_cap=B)


def main_config(full_depth=False):
    """minitron-8b at full width in bf16 on the card, Ada-SnapKV budget 256
    (capacity 576), 8 shards x 2 slots; planner sha (callers replace it);
    cut to ``MAIN_LAYERS`` layers unless ``full_depth``."""
    from repro_torch.api import CompressionConfig, EngineConfig
    cfg = EngineConfig.for_arch(
        ARCH, n_shards=N_SHARDS, dtype="bfloat16", max_seq_len=T + GEN,
        seed=SEED, device="cuda",
        compression=CompressionConfig(policy="ada_snapkv", budget=BUDGET,
                                      alpha_max=ALPHA, obs_window=OBS, pool=POOL,
                                      sink=SINK, decode_margin=MARGIN),
        planner=planner("sha", 0))
    if full_depth:
        return cfg
    return cfg.replace(model=cfg.model.with_overrides(n_layers=MAIN_LAYERS))


def main_path():
    import numpy as np
    import torch
    from repro_torch.api import Engine
    from repro_torch.configs.base import InputShape
    from repro_torch.kernels import build
    from repro_torch.training.data import SyntheticLM

    cfg = main_config()
    m = cfg.model
    log(f"[main] {m.name}: {m.n_layers} layers (cut in depth), d_model {m.d_model}, "
        f"{m.n_heads}/{m.n_kv_heads} heads, head_dim {m.head_dim}, d_ff {m.d_ff}, "
        f"vocab {m.vocab_size}, bf16; S={N_SHARDS * SLOTS_PER_SHARD} slots, "
        f"capacity {cfg.compression.static_capacity()}, B={B}, T={T}, {GEN} new tokens")
    data = SyntheticLM(m, InputShape("chip_smoke", T, B, "prefill"))
    prompts = data.get_batch(0)["tokens"]
    sample = data.get_batch(123)["tokens"]

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    probe = Engine.build(cfg)
    torch.cuda.synchronize()
    log(f"[main] weights initialised on the card in {time.perf_counter() - t0:.1f} s")
    params = probe.params

    build.reset_launches()
    profile = probe.measure_profile(sample)
    del probe
    gc.collect()
    torch.cuda.empty_cache()
    if build.LAUNCHES["snapkv_scores"] != m.n_layers:
        fail(f"measure_profile launched snapkv_scores {build.LAUNCHES['snapkv_scores']} "
             f"times, expected {m.n_layers}")

    results = {}
    eng = None
    for mode, ch in PLANNERS:
        # free the previous engine's slot weights and cache first; the
        # original-layout weights are shared
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(cfg.replace(planner=planner(mode, ch)), params=params,
                           profile=profile)
        before = dict(build.LAUNCHES)
        teacher = None if mode == "sha" else results["sha"].tokens[:, :GEN]
        res = eng.generate(prompts, GEN, teacher_tokens=teacher)
        got = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
        if got["fairkv_decode"] != m.n_layers * GEN:
            fail(f"{mode}: fairkv_decode launched {got['fairkv_decode']} times, "
                 f"expected n_layers x {GEN} = {m.n_layers * GEN}")
        if got["snapkv_scores"] != m.n_layers:
            fail(f"{mode}: snapkv_scores launched {got['snapkv_scores']} times, "
                 f"expected n_layers = {m.n_layers}")
        if res.logits.shape != (B, GEN + 1, m.padded_vocab) or not np.isfinite(res.logits).all():
            fail(f"{mode}: logits of shape {res.logits.shape} or not finite")
        results[mode] = res
        step_ms = 1e3 * statistics.median(res.step_s)
        # the highest percentile with at least 10 of the steps beyond it
        q = max(50.0, 100.0 * (1.0 - 10.0 / len(res.step_s)))
        tail_ms = 1e3 * float(np.percentile(res.step_s, q))
        log(f"[main] {mode:12s} prefill {res.prefill_s:.3f} s | decode median "
            f"{step_ms:.2f} ms/step, p{q:.0f} {tail_ms:.2f} ms (n={len(res.step_s)}) | "
            f"{B / (step_ms / 1e3):.1f} tokens/s | "
            f"E={res.efficiency:.4f} makespan={res.makespan:.1f} | "
            f"replicas {int((eng.plan.as_arrays()['slot_head'] >= 0).sum())}")
    launches = dict(build.LAUNCHES)
    log(f"[main] launches over the slot one-shot path (measure_profile + 3 x generate): "
        f"{launches}")
    if launches["paged_fairkv_decode"] != 0:
        fail("the slot backend launched the paged kernel")

    lens = [results[mode].lengths for mode, _ in PLANNERS]
    if not all(np.array_equal(lens[0], x) for x in lens[1:]):
        fail("realized lengths differ across planners")
    log("[main] realized lengths (L, Hkv, B) bitwise equal across sha / fairkv_nodp / fairkv_dp")
    ref_l = results["sha"].logits
    # bound from bf16 rounding: the plans compute the same function, and each
    # of the n_layers residual updates is rounded to bf16 (relative step
    # 2^-8) in an order that depends on the slot layout; propagated through
    # the normed read-out that bounds the logit gap by n_layers * 2^-8 of the
    # largest logit.  Both runs are fed the same tokens (teacher forcing).
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(ref_l).max())
    for mode in ("fairkv_nodp", "fairkv_dp"):
        d = float(np.abs(results[mode].logits - ref_l).max())
        same = float((results[mode].tokens == results["sha"].tokens).mean())
        log(f"[main] max |logits_sha - logits_{mode}| = {d:.4f} (bound {tol:.4f}); "
            f"argmax tokens equal to sha's at {100 * same:.1f}% of positions")
        if not d < tol:
            fail(f"plan invariance: {mode} logits differ by {d} >= {tol}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[main] torch.cuda.max_memory_allocated = {peak / 2**30:.2f} GiB")

    share = profile_decode(eng, statistics.median(results["fairkv_dp"].step_s))
    profile_prefill(eng, prompts)
    mode_rows = {mode: {"prefill_s": r.prefill_s,
                        "decode_ms_median": 1e3 * statistics.median(r.step_s),
                        "efficiency": r.efficiency, "makespan": r.makespan}
                 for mode, r in results.items()}
    log("[main] summary " + json.dumps({"planners": mode_rows,
                                         "max_memory_allocated": peak,
                                         "kernel_share_of_decode": share}))
    ctx = {"cfg": cfg.replace(planner=planner("fairkv_dp", 4)), "params": params,
           "profile": profile, "prompts": prompts, "slot_dp": results["fairkv_dp"],
           "teacher": results["sha"].tokens[:, :GEN]}
    return eng, launches, ctx


# (step kind, "graphs" | "eager") -> (host-clocked ms, device ms) per step,
# filled by the profiling passes, printed by phase 9 (graphs_vs_eager)
TIMES = {}


def _device_profile(fn, ours_keys=("fairkv_decode_kernel", "snapkv_")):
    """Run ``fn`` under torch.profiler; returns (wall s, total device us,
    device us of the kernels whose names contain one of ``ours_keys``, top
    kernels [(name, us)])."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        wall = time.perf_counter() - t0
    total = ours = 0.0
    kernels = []
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            us = ev.self_device_time_total
            total += us
            kernels.append((ev.key[:70], us))
            if any(k in ev.key for k in ours_keys):
                ours += us
    kernels.sort(key=lambda kv: -kv[1])
    return wall, total, ours, kernels[:6]


def profile_decode(eng, step_s, steps=4, label="graphs"):
    """One torch.profiler pass over a few decode steps (and one over a
    prefill): the kernels' share of device time, the top device kernels,
    and the device's busy share of the wall time (under the profiler, and
    against ``step_s``, the un-profiled median step).  ``label`` names the
    executor (CUDA graphs or eager) in `TIMES`."""
    box = {"state": eng.state}

    def decode():
        for _ in range(steps):
            box["state"], _ = eng.executor.decode(eng.sp, box["state"], eng.pa)

    wall, total, ours, top = _device_profile(decode)
    eng.state = box["state"]
    if total <= 0:
        log("[profile] torch.profiler recorded no device time: share not measured")
        return None
    share = ours / total
    TIMES[("one-shot step", label)] = (1e3 * step_s, total / 1e3 / steps)
    log(f"[profile] {label}: {steps} decode steps: device busy {total / 1e3:.2f} ms of "
        f"{wall * 1e3:.2f} ms wall ({100 * total / 1e6 / wall:.1f}%); "
        f"fairkv_decode kernel {ours / 1e3:.3f} ms = {100 * share:.2f}% of device time; "
        f"device time per step {total / 1e3 / steps:.2f} ms = "
        f"{100 * total / 1e6 / steps / step_s:.1f}% of the un-profiled median step "
        f"({step_s * 1e3:.2f} ms)")
    for name, us in top:
        log(f"[profile]   decode top kernel {us / 1e3 / steps:8.3f} ms/step  {name}")
    return share


def profile_prefill(eng, prompts):
    """One torch.profiler pass over a prefill (its state is discarded)."""
    import torch
    batch = {"tokens": torch.as_tensor(prompts, dtype=torch.int64, device=eng.device)}
    wall, total, ours, top = _device_profile(
        lambda: eng.executor.prefill(eng.sp, batch, eng.pa))
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for prefill")
        return
    log(f"[profile] prefill: device busy {total / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
        f"wall; snapkv_scores kernels {ours / 1e3:.3f} ms = {100 * ours / total:.2f}%")
    for name, us in top:
        log(f"[profile]   prefill top kernel {us / 1e3:9.3f} ms  {name}")


# ---------------------------------------------------------------------------
# phase 6: the paged backend, one-shot (bf16 pools next to the slot run,
# then int8 and fp8 pools against the bf16 pools)
# ---------------------------------------------------------------------------

# int8 / fp8 pools against bf16 pools, both teacher-forced on the same
# tokens (32 steps x 8 rows = 256 positions + the prefill's 8).  The bars
# sit about 8-10x the measured 1 - cosine (1.2e-4 int8, 2.1e-4 fp8 on an
# H100, PERF.md) and 6-10 points under the measured argmax agreement
# (96.6% / 95.1%), which is itself near the floor of bf16 rounding alone
# (the bf16 plans agree on ~97.5% of argmax tokens: random-weight logits
# are nearly flat).  e4m3 (relative step 1/16) is coarser than int8
# (1/254 of the block's amax), so its bars are looser.  ``min_gap`` is the
# other side: the logits must differ from the bf16 pools', or the pools
# were not quantized.
QUANT_BARS = {"int8": {"cosine": 0.999, "argmax": 0.90, "min_gap": 1e-3},
              "fp8": {"cosine": 0.998, "argmax": 0.85, "min_gap": 1e-3}}


def _count(fn):
    """Run ``fn`` with the launch counters zeroed just before; returns
    (result, launches during the run)."""
    from repro_torch.kernels import build
    build.reset_launches()
    out = fn()
    return out, dict(build.LAUNCHES)


def _layer0(cache):
    """Layer 0 of a paged cache, cloned (the kernel's own inputs)."""
    t = {"k_pool": cache.k_pool[0], "v_pool": cache.v_pool[0],
         "pos_pool": cache.pos_pool[0], "table": cache.block_table[0],
         "lengths": cache.lengths[0], "positions": cache.positions}
    if cache.k_scale is not None:
        t["k_scale"], t["v_scale"] = cache.k_scale[0], cache.v_scale[0]
    return {k: v.clone() for k, v in t.items()}


def paged_oneshot(ctx):
    """`Engine.generate` with ``cache_backend="paged"`` at full width:
    bf16 pools at worst-case size next to the slot run of the same plan
    (lengths bitwise, logit gap under the bf16 bound, the paged kernel on
    every layer of every step and the slot kernel never), then int8 and
    fp8 pools against the bf16 pools (QUANT_BARS)."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig
    m = ctx["cfg"].model
    out = {"launches": {}}
    ref = None
    for kv in ("fp32", "int8", "fp8"):
        gc.collect()
        torch.cuda.empty_cache()
        cfg = ctx["cfg"].replace(cache_backend="paged",
                                 paging=PagingConfig(block_size=BLOCK, kv_dtype=kv))
        eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
        res, got = _count(lambda: eng.generate(ctx["prompts"], GEN,
                                               teacher_tokens=ctx["teacher"]))
        name = "bf16" if kv == "fp32" else kv
        mem = eng.memory_stats()
        log(f"[paged] one-shot {name} pools: prefill {res.prefill_s:.3f} s | decode median "
            f"{1e3 * statistics.median(res.step_s):.2f} ms/step | blocks in use "
            f"{mem['blocks_in_use']} of {mem['blocks_total']} ({mem['cache_bytes']} B vs "
            f"{mem['slot_equivalent_bytes']} B slot-equivalent) | launches {got}")
        if got["paged_fairkv_decode"] != m.n_layers * GEN or got["fairkv_decode"] != 0:
            fail(f"paged {name}: paged_fairkv_decode launched {got['paged_fairkv_decode']} "
                 f"times (expected {m.n_layers} x {GEN}), fairkv_decode "
                 f"{got['fairkv_decode']} (expected 0)")
        if not np.isfinite(res.logits).all():
            fail(f"paged {name}: non-finite logits")
        for k, v in got.items():
            out["launches"][k] = out["launches"].get(k, 0) + v
        out[name] = _layer0(eng.state.cache)
        profile_paged_step(eng, name)
        if kv == "fp32":
            slot = ctx["slot_dp"]
            if not np.array_equal(res.lengths, slot.lengths):
                fail("paged vs slot: retained lengths differ")
            tol = m.n_layers * 2.0 ** -8 * float(np.abs(slot.logits).max())
            d = float(np.abs(res.logits - slot.logits).max())
            same = float((res.tokens == slot.tokens).mean())
            log(f"[paged] bf16 pools vs slot cache (fairkv_dp, teacher-forced): lengths "
                f"bitwise equal; max |logit gap| {d:.4f} (bound {tol:.4f}); argmax equal "
                f"at {100 * same:.1f}% of positions")
            if not d < tol:
                fail(f"paged vs slot: logit gap {d} >= {tol}")
            ref = res
        else:
            a = torch.from_numpy(res.logits).double().reshape(-1, res.logits.shape[-1])
            b = torch.from_numpy(ref.logits).double().reshape(-1, ref.logits.shape[-1])
            cos = float(torch.nn.functional.cosine_similarity(a, b, dim=-1).mean())
            agree = float((res.tokens == ref.tokens).mean())
            gap = float(np.abs(res.logits - ref.logits).max())
            bars = QUANT_BARS[kv]
            log(f"[paged] {kv} pools vs bf16 pools (teacher-forced): mean logit cosine "
                f"{cos:.6f} (bar {bars['cosine']}), argmax agreement {100 * agree:.1f}% "
                f"(bar {100 * bars['argmax']:.0f}%), max |logit gap| {gap:.4f} "
                f"(must exceed {bars['min_gap']:g})")
            if cos < bars["cosine"] or agree < bars["argmax"]:
                fail(f"{kv} pools below their quality bars")
            if gap <= bars["min_gap"]:
                fail(f"{kv} pools give the bf16 pools' logits: not quantized")
        del eng, res
    return out


def profile_paged_step(eng, name, steps=2):
    """Where a one-shot paged step's time goes (bf16, int8 or fp8 pools):
    the host time of `prepare_decode` and, under torch.profiler, the
    device time per step of the graphed decode step and its top kernels."""
    import torch
    prep = []

    def step():
        t0 = time.perf_counter()
        state = eng.backend.prepare_decode(eng.state, None)
        prep.append(time.perf_counter() - t0)
        eng.state, _ = eng.executor.decode(eng.sp, state, eng.pa)

    with torch.inference_mode():
        wall, total, ours, top = _device_profile(lambda: [step() for _ in range(steps)],
                                                 ours_keys=("paged_decode_kernel",))
    if total <= 0:
        log(f"[profile] torch.profiler recorded no device time for the {name} paged step")
        return
    log(f"[profile] one-shot paged step, {name} pools: device {total / 1e3 / steps:.2f} ms per "
        f"step ({100 * total / 1e6 / wall:.1f}% of the profiled wall); prepare_decode "
        f"{1e3 * statistics.mean(prep):.2f} ms host per step; paged_fairkv_decode "
        f"{ours / 1e3 / steps:.3f} ms per step")
    for kname, us in top[:4]:
        log(f"[profile]   {name} step top kernel {us / 1e3 / steps:8.3f} ms/step  {kname}")


# ---------------------------------------------------------------------------
# phase 7: continuous batching at full width
# ---------------------------------------------------------------------------

N_REQ, RATE, PROMPT_MIN, PROMPT_MAX, NEW_MIN, NEW_MAX, MAX_ROWS = 24, 0.25, 512, 2048, 16, 64, 8
# undersized pool of run (d), in admission charges of the largest request.
# Admission charges a request its prefill bound plus one growth block per
# head, about 30 blocks per layer more than a request realizes at prefill,
# and that slack covers most of a request's own 16-64-token growth; so on
# this trace a dry pool is rare and depends on how the growth of
# concurrent requests lines up.  3.6 preempts 6 times (a sweep of sizes on
# this trace, PERF.md); the trace and the realized lengths are
# deterministic, so a run that does not preempt means admission changed.
UNDERSIZE = 3.6


def make_trace(vocab):
    """24 requests from `synthesize_requests` (seed 0): Poisson arrivals,
    prompts of 512-2048 tokens; 16-64 new tokens each, drawn from a numpy
    generator of the same seed."""
    import numpy as np
    from repro_torch.api import synthesize_requests
    reqs = synthesize_requests(N_REQ, RATE, vocab, min_prompt=PROMPT_MIN,
                               max_prompt=PROMPT_MAX, max_new_tokens=NEW_MAX, seed=SEED)
    gen = np.random.default_rng(SEED).integers(NEW_MIN, NEW_MAX + 1, size=N_REQ)
    for r, g in zip(reqs, gen):
        r.max_new_tokens = int(g)
    return reqs


def eager_executor(cfg):
    """A `LocalExecutor` that runs every step eagerly (no CUDA graph): the
    comparison phase 9 holds the graphs to."""
    from repro_torch.exec.local import LocalExecutor
    return LocalExecutor(cfg.model, cfg.compression, paging=cfg.paging, device="cuda",
                         graphs=False)


def continuous_run(ctx, name, backend, kv, n_blocks=0, spec=None, logits=False,
                   changes=None, reqs=None, eager=False, head_importance=None, inspect=None,
                   mesh=None):
    """One trace through `Engine.run_trace` (8 rows, replanning on with
    `SchedulerConfig`'s defaults) with the launch counters zeroed just
    before and read just after; checks that every request finished with
    all its tokens, the launch counts, and (paged) an empty, consistent
    pool at the end (after flushing the prefix index, when there is one).
    ``spec`` (a `SpeculationConfig`) turns speculation on; ``logits``
    keeps each token's logits; ``changes`` are further `EngineConfig`
    fields (compression, planner, scheduler, prefix, ...) and ``reqs`` a
    trace other than `make_trace`'s.  With sharing on, the largest block
    refcount seen while requests are live is recorded after every tick.
    The steps run as CUDA graphs, captured by `Engine.warmup` before the
    counted run; the trace must capture nothing more (replans, splices,
    retirements and copy-on-write write into the captured tensors).
    ``eager`` runs every step eagerly instead.  ``head_importance`` goes to
    `Engine.build` (the ``headkv`` policy's weights); ``inspect(eng,
    after_warmup)`` is called after the checks with the engine and the
    ``stepfn_compiles_total`` counts read just after warmup.  ``mesh`` runs
    the engine as this process's rank of a mesh (the ``mesh`` executor;
    eager on gloo).  Returns (launches, summary)."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig, SpeculationConfig
    m = ctx["cfg"].model
    spec = spec or SpeculationConfig()
    gc.collect()
    torch.cuda.empty_cache()
    fields = dict(cache_backend=backend,
                  scheduler=SchedulerConfig(max_rows=MAX_ROWS, collect_logits=logits),
                  paging=PagingConfig(block_size=BLOCK, kv_dtype=kv, n_blocks=n_blocks),
                  speculation=spec)
    cfg = ctx["cfg"].replace(**{**fields, **(changes or {})})
    if mesh is not None:
        cfg = cfg.replace(executor="mesh")
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"],
                       head_importance=head_importance, mesh=mesh)
    if eager and mesh is None:
        eng.executor = eager_executor(cfg)
    reqs = make_trace(m.vocab_size) if reqs is None else reqs
    n_req = len(reqs)
    chunk = cfg.prefix.chunk_tokens
    if chunk and min(r.prompt_len for r in reqs) <= chunk:
        fail(f"{name}: every prompt must be longer than one chunk ({chunk} tokens)")
    sched = eng._ensure_scheduler()
    max_ref = [0]
    if sched.prefix is not None:
        tick = sched.step

        def watched():
            ev = tick()
            if sched.active:
                max_ref[0] = max(max_ref[0], int(sched.backend.pool.refcount[:, 1:].max()))
            return ev
        sched.step = watched
    ex = eng.executor
    eager = not ex.graphs
    t_warm = time.perf_counter()
    eng.warmup()
    t_warm = time.perf_counter() - t_warm
    captured = dict(ex.step_traces)
    compiles_warm = {k: eng.obs.metrics.counter_value("stepfn_compiles_total", kind=k,
                                                      executor=ex.name)
                     for k in ex.step_traces}
    # one capture per distinct step shape: the decode step, the chunk step
    # when chunking, propose and verify when speculating; prefill is eager
    shapes = {"prefill": 0, "decode": 1, "prefill_chunk": int(bool(chunk)),
              "propose": int(spec.enabled), "verify": int(spec.enabled)}
    if not eager and captured != shapes:
        fail(f"{name}: warmup captured {captured}, expected one graph per step shape {shapes}")
    torch.cuda.reset_peak_memory_stats()
    summary, got = _count(lambda: eng.run_trace(reqs, max_steps=5000))
    ticks = summary["decode_ticks"]
    if ex.step_traces != captured:
        fail(f"{name}: the trace captured again: {ex.step_traces} after warmup's {captured}")
    admissions = n_req + summary["preemptions"]
    lat = summary["latency"]
    step_ms = 1e3 * np.asarray(sched.step_s)
    acc = sum(1 for e in summary["replan_log"] if e["accepted"])
    rej = len(summary["replan_log"]) - acc
    in_use = summary["memory"].get("blocks_in_use", 0)
    peak_blocks = summary["memory"].get("peak_blocks_in_use_per_layer", 0)
    host_ms = {k: 1e3 * float(np.median(getattr(sched, k))) if getattr(sched, k) else None
               for k in ("prepare_s", "propose_s", "verify_s", "chunk_s")}
    held, stats = 0, eng.prefix_stats()
    if sched.prefix is not None:  # blocks only the index holds, then none
        held = sched.backend.pool.blocks_in_use()
        sched.prefix.flush()
    log(f"[cont] {name:10s} finished {summary['finished']}/{n_req} | tokens "
        f"{summary['generated_tokens']} | steps {summary['steps']} (decode ticks {ticks}) | "
        f"preemptions {summary['preemptions']} | replans accepted {acc} rejected {rej} | "
        f"step median {np.median(step_ms):.2f} ms p90 {np.percentile(step_ms, 90):.2f} ms | "
        f"TTFT p50 {lat.get('p50_ttft_s', float('nan')):.3f} s p99 "
        f"{lat.get('p99_ttft_s', float('nan')):.3f} s | {summary['tokens_per_s']:.1f} tokens/s | "
        f"peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB | "
        + (f"pool {n_blocks or 'worst-case'} blocks/layer, peak in use {peak_blocks}/layer, "
           f"in use at the end {in_use} | " if backend == "paged" else "")
        + (f"chunks {len(sched.chunk_s)} of {chunk} tokens, host ms median "
           f"{host_ms['chunk_s']:.2f} | cow copies {sched.backend.cow_copies} | "
           if chunk else "")
        + (f"prefix index {stats}, max refcount while live {max_ref[0]}, "
           f"{held} blocks held by the index at the end | " if stats else "")
        + (f"acceptance {summary['acceptance']:.4f} ({summary['spec_accepted']}/"
           f"{summary['spec_proposed']}) | host ms per tick (median): prepare "
           f"{host_ms['prepare_s']:.2f}, propose {host_ms['propose_s']:.2f}, verify "
           f"{host_ms['verify_s']:.2f} | " if spec.enabled else "")
        + f"launches {got} | "
        + ("eager executor" if eager else
           f"CUDA graphs captured by warmup ({t_warm:.2f} s) {captured}, replays "
           f"{ex.replays}"))
    if summary["finished"] != n_req or any(not r.is_finished or r.cancelled for r in reqs):
        fail(f"{name}: {summary['finished']} of {n_req} requests finished")
    if summary["generated_tokens"] != sum(r.max_new_tokens for r in reqs):
        fail(f"{name}: generated {summary['generated_tokens']} tokens, expected "
             f"{sum(r.max_new_tokens for r in reqs)}")
    decode_kernel = "paged_fairkv_decode" if backend == "paged" else "fairkv_decode"
    other = "fairkv_decode" if backend == "paged" else "paged_fairkv_decode"
    n_attn = 0 if m.attention_free else m.n_layers  # layers that launch kernels
    expect = {decode_kernel: n_attn * ticks, other: 0, "paged_fairkv_decode_mq": 0}
    if spec.enabled:
        # every tick: max_k draft steps over the draft layers (paged kernel),
        # then one verify over every layer (multi-query kernel)
        d = spec.draft_layers or m.n_layers
        expect.update(paged_fairkv_decode=d * spec.max_k * ticks,
                      paged_fairkv_decode_mq=m.n_layers * ticks)
    if any(got[k] != v for k, v in expect.items()):
        fail(f"{name}: launches {got}, expected {expect} ({ticks} ticks)")
    # one launch per layer of every prefill, or of every chunk when chunked
    prefills = len(sched.chunk_s) if chunk else admissions
    if got["snapkv_scores"] != n_attn * prefills:
        fail(f"{name}: snapkv_scores launched {got['snapkv_scores']} times, expected "
             f"{n_attn} x {prefills} {'chunks' if chunk else 'prefills'}")
    if backend == "paged" and not m.attention_free:
        pool = sched.backend.pool
        pool.check_invariants()
        if pool.blocks_in_use() != 0:
            fail(f"{name}: {pool.blocks_in_use()} blocks still in use at the end")
        log(f"[cont] {name}: BlockPool.check_invariants() passed; 0 blocks in use")
    out = {k: summary[k] for k in ("steps", "decode_ticks", "wall_s", "finished",
                                   "generated_tokens", "replans", "preemptions",
                                   "tokens_per_s", "acceptance")}
    out.update(step_ms_median=float(np.median(step_ms)),
               step_ms_p90=float(np.percentile(step_ms, 90)),
               ttft_s_p50=lat.get("p50_ttft_s"), ttft_s_p99=lat.get("p99_ttft_s"),
               replans_accepted=acc, replans_rejected=rej,
               peak_memory=torch.cuda.max_memory_allocated(), peak_blocks=peak_blocks,
               n_blocks=n_blocks, tokens=[list(r.generated) for r in reqs],
               replan_decisions=[e["accepted"] for e in summary["replan_log"]],
               chunks=len(sched.chunk_s), prefix=stats, max_refcount=max_ref[0],
               index_blocks_at_end=held, cow_copies=getattr(sched.backend, "cow_copies", 0),
               hit_tokens=[r.prefix_hit_tokens for r in reqs],
               captures=captured, eager=eager,
               **{f"{k[:-2]}_ms_median": v for k, v in host_ms.items()})
    if logits:
        out["logits"] = [np.stack(r.logits) for r in reqs]
    if inspect is not None:
        inspect(eng, compiles_warm)
    return got, out


def undersized_blocks(ctx, factor: float) -> int:
    """Pool size (blocks per layer) of an undersized run: ``factor`` times
    the admission charge of the largest request, and never below the
    worst case of a single request (which `never_fits` requires)."""
    from repro_torch.api import PagingConfig
    from repro_torch.paging.backend import PagedBackend
    probe = PagedBackend(ctx["cfg"].model, ctx["cfg"].compression,
                         paging=PagingConfig(block_size=BLOCK))
    admit = int(probe._layer_blocks(PROMPT_MAX, NEW_MAX, False).max())
    worst = int(probe._layer_blocks(PROMPT_MAX, NEW_MAX, True).max())
    return max(int(factor * admit), worst) + 1


# speculative runs of the continuous trace: (e) a draft of a quarter of the
# stack (2 of phases 5-15's 8 layers) with adaptive depth, (f) the
# full-depth self-draft, whose acceptance would be 1.0 in exact arithmetic;
# in bf16 the draft's single-row projections and the verify's B*Q-row ones
# may round apart; gemma2-9b (phase 16) drafts with 2 of its 10 layers
SPEC_E = dict(enabled=True, max_k=4, draft_layers=MAIN_LAYERS // 4)
SPEC_GEMMA = dict(SPEC_E, draft_layers=2)
SPEC_F = dict(enabled=True, max_k=4, draft_layers=0)
SPEC_F_ACCEPTANCE = 0.90


def near_tie_check(plain, spec, m):
    """(e) against the plain bf16 run (b), both with per-token logits:
    while a request's tokens agree (its first differing position
    included: the history is still the same) the logit gap stays under
    the bf16 bound n_layers * 2^-8 * max|logit|, and at the first
    differing position the plain run's top-2 margin is under it too, so
    every divergence is a near-tie.  Returns (identical requests, max gap,
    bound, margins at the divergences)."""
    import numpy as np
    V = m.vocab_size
    bound = m.n_layers * 2.0 ** -8 * max(float(np.abs(x[:, :V]).max())
                                         for x in plain["logits"])
    same, gap, margins = 0, 0.0, []
    for i in range(N_REQ):
        a, b = plain["tokens"][i], spec["tokens"][i]
        first = next((t for t in range(len(a)) if a[t] != b[t]), None)
        upto = len(a) if first is None else first + 1
        la, lb = plain["logits"][i][:upto, :V], spec["logits"][i][:upto, :V]
        gap = max(gap, float(np.abs(la - lb).max()))
        if first is None:
            same += 1
            continue
        top2 = np.sort(la[first])[-2:]
        margins.append(float(top2[1] - top2[0]))
    if not gap < bound:
        fail(f"spec vs plain bf16: logit gap {gap:.4f} >= bound {bound:.4f} while the "
             f"tokens agree")
    if any(mg >= bound for mg in margins):
        fail(f"spec vs plain bf16: a divergence with top-2 margin {max(margins):.4f} >= "
             f"bound {bound:.4f} is not a near-tie")
    return same, gap, bound, margins


def continuous_runs(ctx):
    """The same trace on (a) the slot backend, (b) bf16 pools at worst-case
    size, (c) int8 pools at worst-case size, (d) fp8 pools sized below the
    realized need (`undersized_blocks`), which must preempt; then
    speculative decoding on (e) bf16 pools with a 2-layer draft, (f) bf16
    pools with the full-depth self-draft and (g) int8 pools with (e)'s
    draft.  Returns (launches, the mq kernel's inputs at a verify tick)."""
    from repro_torch.api import SpeculationConfig
    m = ctx["cfg"].model
    launches, runs = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for name, backend, kv in (("slot", "slot", "fp32"), ("paged bf16", "paged", "fp32"),
                              ("paged int8", "paged", "int8")):
        got, runs[name] = continuous_run(ctx, name, backend, kv,
                                         logits=name == "paged bf16")
        add(got)
    n_blocks = undersized_blocks(ctx, UNDERSIZE)
    got, runs["paged fp8"] = continuous_run(ctx, "paged fp8", "paged", "fp8", n_blocks)
    add(got)
    if runs["paged fp8"]["preemptions"] < 1:
        fail(f"paged fp8: the undersized pool ({n_blocks} blocks/layer, {UNDERSIZE} "
             f"admission charges) never preempted")
    # the paged kernel gives the slot kernel's outputs bitwise on the same
    # cache contents (PERF.md), so the two traces must agree token for token
    # and take the same replan decisions
    a, b = runs["slot"], runs["paged bf16"]
    same = sum(x == y for x, y in zip(a["tokens"], b["tokens"]))
    log(f"[cont] slot vs paged bf16: {same}/{N_REQ} requests with identical tokens; "
        f"replan decisions {a['replan_decisions']} vs {b['replan_decisions']}")
    if same != N_REQ:
        fail(f"slot vs paged bf16: only {same}/{N_REQ} requests with identical tokens")
    if a["replan_decisions"] != b["replan_decisions"]:
        fail("slot vs paged bf16: the replan decisions differ")

    for name, kv, spec, logits in (("spec (e)", "fp32", SPEC_E, True),
                                   ("spec (f)", "fp32", SPEC_F, False),
                                   ("spec (g)", "int8", SPEC_E, False)):
        got, runs[name] = continuous_run(ctx, name, "paged", kv,
                                         spec=SpeculationConfig(**spec), logits=logits)
        add(got)
    plain, e, f, g = (runs[k] for k in ("paged bf16", "spec (e)", "spec (f)", "spec (g)"))
    if not f["acceptance"] >= SPEC_F_ACCEPTANCE:
        fail(f"spec (f) (full-depth self-draft): acceptance {f['acceptance']:.4f} < "
             f"{SPEC_F_ACCEPTANCE}")
    same_e, gap, bound, margins = near_tie_check(plain, e, m)
    same_f = sum(x == y for x, y in zip(plain["tokens"], f["tokens"]))
    same_g = sum(x == y for x, y in zip(runs["paged int8"]["tokens"], g["tokens"]))
    tok_g = sum(sum(p == q for p, q in zip(x, y))
                for x, y in zip(runs["paged int8"]["tokens"], g["tokens"]))
    log(f"[cont] spec (e) vs paged bf16: {same_e}/{N_REQ} requests identical; max logit gap "
        f"while the tokens agree {gap:.4f} (bound {bound:.4f}); top-2 margins of the plain "
        f"run at the {len(margins)} divergences: "
        + ", ".join(f"{x:.4f}" for x in sorted(margins)) + " (all under the bound)")
    log(f"[cont] spec (f) vs paged bf16: {same_f}/{N_REQ} requests identical; acceptance "
        f"{f['acceptance']:.4f} (bar {SPEC_F_ACCEPTANCE})")
    log(f"[cont] spec (g) vs paged int8: {same_g}/{N_REQ} requests identical, {tok_g} of "
        f"{sum(len(x) for x in g['tokens'])} tokens at equal positions (reported, not a bar)")
    for name in ("spec (e)", "spec (f)", "spec (g)"):
        base = runs["paged int8" if name == "spec (g)" else "paged bf16"]
        log(f"[cont] {name}: {runs[name]['tokens_per_s']:.1f} tokens/s = "
            f"{runs[name]['tokens_per_s'] / base['tokens_per_s']:.3f} x its plain run; "
            f"decode ticks {runs[name]['decode_ticks']} vs {base['decode_ticks']}")
    log("[cont] summary " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "logits")}
         for k, v in runs.items()}))
    ctx["cont_bf16"] = {k: v for k, v in runs["paged bf16"].items()
                        if k not in ("tokens", "logits")}
    # what phase 9 holds the eager runs to
    ctx["graphed"] = {"(b)": {k: runs["paged bf16"][k] for k in ("tokens", "replan_decisions")},
                      "(e)": {k: runs["spec (e)"][k] for k in ("tokens", "acceptance")}}
    del runs, a, b, plain, e, f, g
    gc.collect()
    profile_continuous(ctx)
    mq_inputs = profile_speculative(ctx)
    return launches, mq_inputs


def profile_continuous(ctx, steps=4, eager=False):
    """Where a continuous decode tick's time goes, on paged bf16 pools with
    replanning off (no replan inside the measured ticks): fill all eight
    rows, then a few pure decode ticks un-profiled (with the scheduler's
    own `prepare_decode` host time) and one torch.profiler pass over as
    many more; the requests are cancelled afterwards.  ``eager`` times the
    eager executor instead of the CUDA graphs."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(
        cache_backend="paged", paging=PagingConfig(block_size=BLOCK),
        scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    if eager:
        eng.executor = eager_executor(cfg)
    rng = np.random.default_rng(SEED + 7)
    reqs = [eng.submit(rng.integers(0, cfg.model.vocab_size, size=PROMPT_MAX // 2),
                       max_new_tokens=NEW_MAX) for _ in range(MAX_ROWS)]
    sched = eng.scheduler
    while sched.queue:
        eng.step()
    t_plain = time.perf_counter()
    for _ in range(steps):
        eng.step()
    plain_ms = 1e3 * (time.perf_counter() - t_plain) / steps
    spent = sched.prepare_s[-steps:]
    wall, total, ours, top = _device_profile(lambda: [eng.step() for _ in range(steps)],
                                             ours_keys=("paged_decode_kernel",))
    for r in reqs:
        eng.cancel(r.req_id)
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for the continuous ticks")
        return
    label = "eager" if eager else "graphs"
    TIMES[("continuous tick", label)] = (plain_ms, total / 1e3 / steps)
    log(f"[profile] {label}: continuous paged bf16, {MAX_ROWS} live rows: un-profiled tick "
        f"{plain_ms:.2f} ms; prepare_decode {1e3 * float(np.mean(spent)):.3f} ms host per "
        f"tick; profiled {steps} ticks: device busy {total / 1e3:.2f} ms of {wall * 1e3:.2f} ms "
        f"wall ({100 * total / 1e6 / wall:.1f}%), device time per tick {total / 1e3 / steps:.2f} ms "
        f"= {100 * total / 1e6 / steps / (plain_ms / 1e3):.1f}% of the un-profiled tick; "
        f"paged_fairkv_decode {ours / 1e3 / steps:.3f} ms per tick "
        f"({100 * ours / total:.2f}% of device time)")
    for name, us in top:
        log(f"[profile]   tick top kernel {us / 1e3 / steps:8.3f} ms/tick  {name}")


def profile_speculative(ctx, steps=4, eager=False):
    """Where a speculative tick's time goes, with (e)'s speculation on paged
    bf16 pools and replanning off: fill all eight rows, then a few ticks
    un-profiled (with the scheduler's host timers of prepare, propose and
    verify) and one torch.profiler pass over as many more, which gives the
    multi-query kernel's share of device time.  One more tick records the
    multi-query kernel's inputs at layer 0 (Q = max_k + 1 = 5), which phase
    10 times; that tick runs eagerly (a graph replay calls no Python, so
    nothing could record its inputs).  The requests are cancelled
    afterwards.  ``eager`` times the eager executor instead of the CUDA
    graphs and records no inputs."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig, SpeculationConfig
    from repro_torch.kernels import ops
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(
        cache_backend="paged", paging=PagingConfig(block_size=BLOCK),
        scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False),
        speculation=SpeculationConfig(**SPEC_E))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    if eager:
        eng.executor = eager_executor(cfg)
    rng = np.random.default_rng(SEED + 7)
    reqs = [eng.submit(rng.integers(0, cfg.model.vocab_size, size=PROMPT_MAX // 2),
                       max_new_tokens=NEW_MAX) for _ in range(MAX_ROWS)]
    sched = eng.scheduler
    while sched.queue:
        eng.step()
    t_plain = time.perf_counter()
    for _ in range(steps):
        eng.step()
    tick_ms = 1e3 * (time.perf_counter() - t_plain) / steps
    host = {k: 1e3 * float(np.mean(getattr(sched, k)[-steps:]))
            for k in ("prepare_s", "propose_s", "verify_s")}
    wall, total, ours, top = _device_profile(lambda: [eng.step() for _ in range(steps)],
                                             ours_keys=("paged_decode_mq_kernel",))
    label = "eager" if eager else "graphs"
    if total > 0:
        TIMES[("speculative tick", label)] = (tick_ms, total / 1e3 / steps)
    if eager:
        for r in reqs:
            eng.cancel(r.req_id)
        log(f"[profile] eager: speculative tick {tick_ms:.2f} ms un-profiled; host ms per "
            f"tick: prepare {host['prepare_s']:.3f}, propose {host['propose_s']:.2f}, "
            f"verify {host['verify_s']:.2f}; device {total / 1e3 / steps:.2f} ms per tick "
            f"({100 * total / 1e6 / wall:.1f}% busy under the profiler)")
        return None
    seen = {}
    orig = ops.paged_fairkv_decode

    def spy(q, *args, **kw):
        if q.dim() == 5 and not seen:  # the first verify call: layer 0
            seen["args"] = tuple(a.clone() if hasattr(a, "clone") else a
                                 for a in (q,) + args)
            seen["kw"] = {k: v.clone() if hasattr(v, "clone") else v for k, v in kw.items()}
        return orig(q, *args, **kw)

    ops.paged_fairkv_decode = spy
    sched.executor = eager_executor(cfg)
    try:
        eng.step()
    finally:
        ops.paged_fairkv_decode = orig
        sched.executor = eng.executor
    for r in reqs:
        eng.cancel(r.req_id)
    if not seen:
        fail("profile_speculative: no verify call recorded")
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for the speculative ticks")
    else:
        log(f"[profile] graphs: speculative paged bf16 (draft {SPEC_E['draft_layers']} layers, "
            f"max_k {SPEC_E['max_k']}), {MAX_ROWS} live rows: un-profiled tick {tick_ms:.2f} "
            f"ms; host ms per tick: prepare "
            f"{host['prepare_s']:.3f}, propose {host['propose_s']:.2f}, verify "
            f"{host['verify_s']:.2f}; profiled {steps} ticks: device busy {total / 1e3:.2f} ms "
            f"of {wall * 1e3:.2f} ms wall ({100 * total / 1e6 / wall:.1f}%), device time per "
            f"tick {total / 1e3 / steps:.2f} ms; paged_fairkv_decode_mq "
            f"{ours / 1e3 / steps:.3f} ms per tick ({100 * ours / total:.2f}% of device time)")
        for name, us in top:
            log(f"[profile]   spec tick top kernel {us / 1e3 / steps:8.3f} ms/tick  {name}")
    return seen


# ---------------------------------------------------------------------------
# phase 8: chunked prefill and prefix reuse at full width
# ---------------------------------------------------------------------------

CHUNK = 512  # chunk_tokens of the chunked runs
PREFIX_LEN, PREFIX_TEMPLATES, SHARED_FRACTION = 1024, 2, 0.75
PREFIX_PROMPT_MIN, PREFIX_PROMPT_MAX = 1536, 2048
# the prefix index's LRU capacity: the two templates' boundaries at 512
# and 1024 tokens, twice over (an unbounded index keeps every finished
# prompt's suffix blocks until the pool runs dry, and holds more blocks
# than sharing saves)
PREFIX_ENTRIES = 8
# (h) / (i): policy "none" at a budget no row outgrows (prompts up to 2048
# plus up to 64 new tokens, under 2048 + 128), so the recency ring never
# wraps and a request's tokens do not depend on the decode phase
NONE_BUDGET, NONE_MARGIN = 2048, 128
# (j): the reference's ring-wrap case (capacity 64 = 32 + 32, a 48-token
# prefix, chunk 16) scaled to chunk 512: capacity 1280 = 768 + 512, so
# the ring covers columns 768..1279 and wraps into the shared 1024-token
# prefix; the donor (prefix + 64 tokens) reaches capacity after 192 new
# tokens, the late request arrives after the wrap and stays below it
COW_BUDGET, COW_MARGIN, COW_SUFFIX, COW_DONOR_GEN, COW_LATE_GEN, COW_LATE_AT = (
    768, 512, 64, 256, 16, 230)


def make_prefix_trace(vocab):
    """Phase 7's 24 Poisson arrivals and new-token draws with shared
    prefixes: prompts of 1536-2048 tokens, 75% of them starting with one
    of two 1024-token templates (`synthesize_requests`, seed 0)."""
    import numpy as np
    from repro_torch.api import synthesize_requests
    reqs = synthesize_requests(N_REQ, RATE, vocab, min_prompt=PREFIX_PROMPT_MIN,
                               max_prompt=PREFIX_PROMPT_MAX, max_new_tokens=NEW_MAX,
                               seed=SEED, prefix_templates=PREFIX_TEMPLATES,
                               prefix_len=PREFIX_LEN, shared_fraction=SHARED_FRACTION)
    gen = np.random.default_rng(SEED).integers(NEW_MIN, NEW_MAX + 1, size=N_REQ)
    for r, g in zip(reqs, gen):
        r.max_new_tokens = int(g)
    return reqs


def _prefix_changes(enabled, budget=NONE_BUDGET, margin=NONE_MARGIN):
    """`EngineConfig` changes of the policy-"none" runs (h), (i), (j):
    fairkv_dp without extra copies, so no head is replicated.  With
    replicas a request's logits depend on the row it lands in (the slot
    of its head's replica sets the order of the o-projection's sum), and
    sharing changes the rows requests land in (hits skip chunks, rows
    free earlier), so tokens could be compared only up to bf16 near-ties."""
    from repro_torch.api import CompressionConfig, PrefixConfig, SchedulerConfig
    return dict(
        compression=CompressionConfig(policy="none", budget=budget, capacity=budget,
                                      obs_window=OBS, pool=POOL, sink=SINK,
                                      decode_margin=margin),
        planner=planner("fairkv_dp", 0),
        scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False),
        max_seq_len=PREFIX_PROMPT_MAX + NEW_MAX + COW_DONOR_GEN,
        prefix=PrefixConfig(enabled=enabled, chunk_tokens=CHUNK,
                            max_entries=PREFIX_ENTRIES))


def prefix_runs(ctx):
    """Chunked prefill and shared-prefix reuse through `Engine.run_trace`
    at full width on bf16 pools (block size 16, 8 rows, chunks of 512):
    (h) policy "none", chunking only, and (i) the same with sharing, on
    `make_prefix_trace` (no replanning): (i) must hit, share blocks
    (refcount > 1 while requests are live), give (h)'s tokens for all 24
    requests with a lower peak of blocks per layer, and leave an empty,
    consistent pool after `flush`; (j) copy-on-write: a donor whose ring
    wraps into its registered prefix and a late request that hits after
    the wrap, against the same two requests without sharing; (k) the main
    path's Ada-SnapKV (fairkv_dp with 4 extra copies, replanning on) with
    sharing on the same trace, beside the same trace through phase 7's
    bf16 configuration (monolithic prefill, no sharing).  Returns the
    launches of all runs."""
    import numpy as np
    from repro_torch.api import PrefixConfig, Request
    m = ctx["cfg"].model
    launches, runs = {}, {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    for name, enabled in (("(h) chunked", False), ("(i) shared", True)):
        got, runs[name] = continuous_run(ctx, name, "paged", "fp32",
                                         changes=_prefix_changes(enabled),
                                         reqs=make_prefix_trace(m.vocab_size))
        add(got)
    h, i = runs["(h) chunked"], runs["(i) shared"]
    same = sum(a == b for a, b in zip(h["tokens"], i["tokens"]))
    hits = sum(1 for t in i["hit_tokens"] if t)
    log(f"[prefix] (i) vs (h): {same}/{N_REQ} requests with identical tokens; {hits} "
        f"requests hit ({i['prefix']['hits']} hits / {i['prefix']['misses']} misses over "
        f"the admission lookups); max refcount while live {i['max_refcount']}; peak blocks "
        f"per layer {i['peak_blocks']} vs {h['peak_blocks']} "
        f"({100 * (1 - i['peak_blocks'] / h['peak_blocks']):.1f}% fewer); TTFT p50 "
        f"{i['ttft_s_p50']:.3f} vs {h['ttft_s_p50']:.3f} s, p99 {i['ttft_s_p99']:.3f} vs "
        f"{h['ttft_s_p99']:.3f} s; {i['tokens_per_s']:.1f} vs {h['tokens_per_s']:.1f} tokens/s; "
        f"chunks {i['chunks']} vs {h['chunks']}")
    if same != N_REQ:
        fail(f"(i) vs (h): only {same}/{N_REQ} requests with identical tokens")
    ctx["graphed"]["(i)"] = {k: i[k] for k in ("tokens", "prefix", "cow_copies", "hit_tokens")}
    if i["prefix"]["hits"] < 1 or i["max_refcount"] <= 1:
        fail(f"(i): no sharing ({i['prefix']}, max refcount {i['max_refcount']})")
    if not i["peak_blocks"] < h["peak_blocks"]:
        fail(f"(i): peak blocks per layer {i['peak_blocks']} not below (h)'s "
             f"{h['peak_blocks']}")

    # (j) copy-on-write at ring wrap: the reference's case, scaled to chunk 512
    rng = np.random.default_rng(SEED + 11)
    shared = rng.integers(1, m.vocab_size, size=PREFIX_LEN)
    sfx = [rng.integers(1, m.vocab_size, size=COW_SUFFIX) for _ in range(2)]

    def cow_reqs():
        return [Request(req_id=0, prompt=np.concatenate([shared, sfx[0]]).astype(np.int32),
                        arrival_step=0, max_new_tokens=COW_DONOR_GEN),
                Request(req_id=1, prompt=np.concatenate([shared, sfx[1]]).astype(np.int32),
                        arrival_step=COW_LATE_AT, max_new_tokens=COW_LATE_GEN)]

    for name, enabled in (("(j) cow", True), ("(j) plain", False)):
        got, runs[name] = continuous_run(
            ctx, name, "paged", "fp32", reqs=cow_reqs(),
            changes=_prefix_changes(enabled, budget=COW_BUDGET, margin=COW_MARGIN))
        add(got)
    cow, plain = runs["(j) cow"], runs["(j) plain"]
    log(f"[prefix] (j): {cow['cow_copies']} blocks copied on write; the late request hit "
        f"{cow['hit_tokens'][1]} tokens; its tokens equal the unshared engine's: "
        f"{cow['tokens'][1] == plain['tokens'][1]}; the donor's: "
        f"{cow['tokens'][0] == plain['tokens'][0]}")
    if cow["cow_copies"] <= 0 or cow["hit_tokens"][1] != PREFIX_LEN:
        fail(f"(j): {cow['cow_copies']} copies on write, late hit {cow['hit_tokens'][1]}")
    if cow["tokens"][1] != plain["tokens"][1]:
        fail("(j): the late sharer's tokens differ from the unshared engine's")

    # (k) the main path's compression with sharing, beside phase 7's bf16 config
    trace = make_prefix_trace(m.vocab_size)
    got, runs["(k) mono"] = continuous_run(ctx, "(k) mono", "paged", "fp32",
                                           reqs=make_prefix_trace(m.vocab_size))
    add(got)
    got, runs["(k) shared"] = continuous_run(
        ctx, "(k) shared", "paged", "fp32", reqs=trace,
        changes=dict(prefix=PrefixConfig(enabled=True, chunk_tokens=CHUNK,
                                         max_entries=PREFIX_ENTRIES)))
    add(got)
    k0, k = runs["(k) mono"], runs["(k) shared"]
    agree = sum(sum(a == b for a, b in zip(x, y)) for x, y in zip(k0["tokens"], k["tokens"]))
    total = sum(len(x) for x in k0["tokens"])
    b = ctx["cont_bf16"]
    log(f"[prefix] (k) Ada-SnapKV with sharing vs phase 7's bf16 configuration on the same "
        f"trace: peak blocks per layer {k['peak_blocks']} vs {k0['peak_blocks']}; TTFT p50 "
        f"{k['ttft_s_p50']:.3f} vs {k0['ttft_s_p50']:.3f} s, p99 {k['ttft_s_p99']:.3f} vs "
        f"{k0['ttft_s_p99']:.3f} s; {k['tokens_per_s']:.1f} vs {k0['tokens_per_s']:.1f} "
        f"tokens/s; {agree}/{total} tokens at equal positions ({100 * agree / total:.1f}%, "
        f"reported, not a bar); {k['prefix']['hits']} hits; phase 7's bf16 run on its own "
        f"trace: peak {b['peak_blocks']}, TTFT p50 {b['ttft_s_p50']:.3f} s p99 "
        f"{b['ttft_s_p99']:.3f} s, {b['tokens_per_s']:.1f} tokens/s")
    if k["prefix"]["hits"] < 1:
        fail(f"(k): no prefix hit ({k['prefix']})")
    log("[prefix] summary " + json.dumps(
        {k_: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "logits")}
         for k_, v in runs.items()}))
    del runs
    profile_chunk(ctx)
    return launches


def profile_chunk(ctx, eager=False):
    """Where a chunked-prefill step's time goes, in (h)'s configuration: a
    2048-token prompt's four chunks into a fresh B = 1 sub-state, the
    first as warm-up, the second un-profiled (host wall), the last two
    under torch.profiler (device busy share and top kernels).  ``eager``
    times the eager executor instead of the CUDA graph."""
    import numpy as np
    import torch
    from repro_torch.api import Engine
    from repro_torch.serving.engine import init_serve_state
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(cache_backend="paged", **_prefix_changes(False))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    if eager:
        eng.executor = eager_executor(cfg)
    m = cfg.model
    prompt = np.random.default_rng(SEED + 13).integers(0, m.vocab_size, size=(1, 4 * CHUNK))
    state = init_serve_state(m, eng.pa, 1, cfg.compression, dtype=torch.bfloat16,
                             device="cuda")
    quota = np.full(m.n_layers, CHUNK)  # policy "none" keeps a whole chunk

    def chunk(j):
        nonlocal state
        state, _, _ = eng.executor.prefill_chunk(
            eng.sp, prompt[:, j * CHUNK:(j + 1) * CHUNK], eng.pa, state, [0],
            [j * CHUNK], [CHUNK], quota)

    chunk(0)
    t0 = time.perf_counter()
    chunk(1)
    plain_ms = 1e3 * (time.perf_counter() - t0)
    wall, total, ours, top = _device_profile(lambda: (chunk(2), chunk(3)),
                                             ours_keys=("snapkv_",))
    if total <= 0:
        log("[profile] torch.profiler recorded no device time for the chunk steps")
        return
    label = "eager" if eager else "graphs"
    TIMES[("chunk step", label)] = (plain_ms, total / 2e3)
    log(f"[profile] {label}: chunked prefill, {CHUNK}-token chunks (policy none, capacity "
        f"{cfg.compression.static_capacity()}): un-profiled {plain_ms:.2f} ms per chunk; "
        f"profiled 2 chunks: device busy {total / 1e3:.2f} ms of {wall * 1e3:.2f} ms wall "
        f"({100 * total / 1e6 / wall:.1f}%); snapkv_scores {ours / 2e3:.3f} ms per chunk "
        f"({100 * ours / total:.2f}% of device time)")
    for name, us in top:
        log(f"[profile]   chunk top kernel {us / 2e3:8.3f} ms/chunk  {name}")
    if eager:  # which ops launch those kernels: one more chunk, by op and shapes
        state = init_serve_state(m, eng.pa, 1, cfg.compression, dtype=torch.bfloat16,
                                 device="cuda")
        rows, _ = _ops_by_shape(lambda: chunk(0))
        for op, shapes, us, n in rows[:6]:
            log(f"[attr]   chunk step {us / 1e3:8.3f} ms  {n:4d} calls  {op}  {shapes}")


# ---------------------------------------------------------------------------
# phase 9: CUDA graphs against eager execution at full width
# ---------------------------------------------------------------------------


def _ops_by_shape(fn):
    """Run ``fn`` under torch.profiler with shapes recorded; returns the
    PyTorch ops that launched device work, grouped by op and input shapes:
    [(op, input shapes, self device us, calls)], largest first, and the
    total device us."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        fn()
    rows, total = [], 0.0
    for ev in prof.key_averages(group_by_input_shape=True):
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            total += ev.self_device_time_total
        elif ev.self_device_time_total > 0:
            rows.append((ev.key, ev.input_shapes, ev.self_device_time_total, ev.count))
    rows.sort(key=lambda r: -r[2])
    return rows, total


def attribute_elementwise(eng):
    """The decode step's ops by input shapes: one eager decode step on the
    main engine under torch.profiler, device time grouped by op and input
    shapes.  The generic elementwise kernel of 7.2 ms per step was einsum
    copying the slot weights to another layout (PERF.md section 5); fails
    if the step copies a slot weight again (an op whose first input has a
    slot weight's element count)."""
    import math
    layers = eng.sp["layers"]
    ex, eng.executor = eng.executor, eager_executor(eng.cfg)
    try:
        state = eng.state
        eng.executor.decode(eng.sp, state, eng.pa)  # warm
        rows, total = _ops_by_shape(lambda: eng.executor.decode(eng.sp, state, eng.pa))
    finally:
        eng.executor = ex
    log(f"[attr] one eager decode step: {total / 1e3:.3f} ms of device time; top ops by "
        f"input shapes:")
    for op, shapes, us, n in rows[:8]:
        log(f"[attr]   {us / 1e3:8.3f} ms  {n:4d} calls  {op}  {shapes}")
    sizes = {layers[0][k].numel() for k in ("wq_s", "wk_s", "wv_s", "wo_s")}
    copies = [r for r in rows if r[0] in ("aten::copy_", "aten::clone", "aten::contiguous")
              and r[1] and math.prod(r[1][0]) in sizes]
    if copies:
        fail(f"the decode step copies a slot weight: {copies}")
    return {"step_device_ms": total / 1e3}


def graphs_vs_eager(ctx):
    """Phase 9: every phase so far ran its steps as CUDA graphs; here the
    main ones run again eagerly and must agree.

    - one-shot fairkv_dp (B = 8, T = 2048, 32 new tokens, teacher-forced
      on sha's tokens): an eager engine gives phase 5's tokens and
      lengths; the logit gap is printed and bounded by n_layers * 2^-8 *
      max|logit|;
    - continuous (b), bf16 pools with replanning: identical tokens and
      replan decisions, the pool empty at the end (`continuous_run`);
    - speculative (e): identical tokens and acceptance;
    - chunked + shared (i): identical tokens, hits and copy-on-write count;
    - host-clocked and device time per one-shot step, continuous tick,
      speculative tick and chunk step, graphed and eager (the profiling
      passes of phases 5-8 timed the graphs; their eager twins run here).

    No eager comparison is cut to a prefix of its trace."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, SpeculationConfig
    m = ctx["cfg"].model
    out = {}

    # one-shot: eager against phase 5's graphed fairkv_dp run
    gc.collect()
    torch.cuda.empty_cache()
    graphed = ctx["slot_dp"]
    eng = Engine.build(ctx["cfg"], params=ctx["params"], profile=ctx["profile"])
    eng.executor = eager_executor(eng.cfg)
    res = eng.generate(ctx["prompts"], GEN, teacher_tokens=ctx["teacher"])
    gap = float(np.abs(res.logits - graphed.logits).max())
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(graphed.logits).max())
    same = bool(np.array_equal(res.tokens, graphed.tokens))
    log(f"[graphs] one-shot fairkv_dp: eager vs CUDA graphs: tokens identical {same}, lengths "
        f"identical {bool(np.array_equal(res.lengths, graphed.lengths))}, max |logit gap| "
        f"{gap:.6f} (bound {tol:.4f})")
    if not same or not np.array_equal(res.lengths, graphed.lengths):
        fail("one-shot: the eager engine's tokens or lengths differ from the graphed engine's")
    if not gap < tol:
        fail(f"one-shot: logit gap {gap} >= {tol}")
    profile_decode(eng, statistics.median(res.step_s), label="eager")
    del eng
    out["oneshot_logit_gap"] = gap

    # continuous (b), speculative (e), chunked + shared (i), eagerly
    g = ctx["graphed"]
    _, b = continuous_run(ctx, "(b) eager", "paged", "fp32", eager=True)
    same = sum(x == y for x, y in zip(b["tokens"], g["(b)"]["tokens"]))
    log(f"[graphs] (b) eager vs graphs: {same}/{N_REQ} requests with identical tokens; replan "
        f"decisions {b['replan_decisions']} vs {g['(b)']['replan_decisions']}")
    if same != N_REQ or b["replan_decisions"] != g["(b)"]["replan_decisions"]:
        fail("(b): the eager run's tokens or replan decisions differ from the graphs'")
    _, e = continuous_run(ctx, "(e) eager", "paged", "fp32", eager=True,
                          spec=SpeculationConfig(**SPEC_E))
    same = sum(x == y for x, y in zip(e["tokens"], g["(e)"]["tokens"]))
    log(f"[graphs] (e) eager vs graphs: {same}/{N_REQ} requests with identical tokens; "
        f"acceptance {e['acceptance']} vs {g['(e)']['acceptance']}")
    if same != N_REQ or e["acceptance"] != g["(e)"]["acceptance"]:
        fail("(e): the eager run's tokens or acceptance differ from the graphs'")
    _, i = continuous_run(ctx, "(i) eager", "paged", "fp32", eager=True,
                          changes=_prefix_changes(True), reqs=make_prefix_trace(m.vocab_size))
    same = sum(x == y for x, y in zip(i["tokens"], g["(i)"]["tokens"]))
    gi = g["(i)"]
    log(f"[graphs] (i) eager vs graphs: {same}/{N_REQ} requests with identical tokens; "
        f"prefix {i['prefix']} vs {gi['prefix']}; cow copies {i['cow_copies']} vs "
        f"{gi['cow_copies']}")
    if (same != N_REQ or i["prefix"] != gi["prefix"] or i["cow_copies"] != gi["cow_copies"]
            or i["hit_tokens"] != gi["hit_tokens"]):
        fail("(i): the eager run's tokens, hits or copy-on-write differ from the graphs'")
    out["eager_runs"] = {k: {kk: v[kk] for kk in ("step_ms_median", "tokens_per_s",
                                                  "ttft_s_p50", "chunk_ms_median",
                                                  "propose_ms_median", "verify_ms_median")}
                         for k, v in (("(b)", b), ("(e)", e), ("(i)", i))}

    profile_continuous(ctx, eager=True)
    profile_speculative(ctx, eager=True)
    profile_chunk(ctx, eager=True)
    for kind in ("one-shot step", "continuous tick", "speculative tick", "chunk step"):
        cells = []
        for label in ("graphs", "eager"):
            if (kind, label) not in TIMES:
                fail(f"no {label} time for the {kind}: its profiler pass recorded no "
                     f"device time")
            host, dev = TIMES[(kind, label)]
            cells.append(f"{label}: host-clocked {host:.2f} ms, device {dev:.2f} ms "
                         f"({100 * dev / host:.1f}% busy)")
        log(f"[graphs] {kind:17s} " + " | ".join(cells))
    out["times"] = {f"{k} ({lab})": v for (k, lab), v in TIMES.items()}
    log("[graphs] summary " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 12: the six compression policies at full width
# ---------------------------------------------------------------------------

# policy runs of phase 12: (label, policy, with head_importance)
POLICY_RUNS = (("streaming_llm", "streaming_llm", False), ("snapkv", "snapkv", False),
               ("pyramidkv", "pyramidkv", False), ("h2o", "h2o", False),
               ("ada_snapkv", "ada_snapkv", False), ("headkv", "headkv", False),
               ("headkv+imp", "headkv", True))


def _policy_config(ctx, policy, mode, ch):
    import dataclasses
    return ctx["cfg"].replace(
        compression=dataclasses.replace(ctx["cfg"].compression, policy=policy),
        planner=planner(mode, ch))


def _step_times(eng, steps=3):
    """Device ms per graphed decode step and kernel 1's device ms per step,
    from one torch.profiler pass over ``steps`` more steps."""
    box = {"state": eng.state}

    def decode():
        for _ in range(steps):
            box["state"], _ = eng.executor.decode(eng.sp, box["state"], eng.pa)

    _, total, ours, _ = _device_profile(decode, ours_keys=("fairkv_decode_kernel",))
    eng.state = box["state"]
    if total <= 0:
        fail("phase 12: torch.profiler recorded no device time for the decode steps")
    return total / 1e3 / steps, ours / 1e3 / steps


def policy_runs(ctx):
    """Phase 12: one-shot B = 8, T = 2048, 32 new tokens under each of the
    six policies (headkv also with phase 5's measured profile as
    ``head_importance``), under sha and fairkv_dp (CH = 4); each fairkv_dp
    plan is built from the policy's own measured profile (a sample batch),
    and fairkv_dp is teacher-forced on sha's tokens.  Bars per policy:
    retained lengths bitwise plan-invariant; balanced policies keep exactly
    min(budget_l, T, C) per head; `layer_keep_bound` >= the realized
    sum of keep of every layer and row; the logit gap of phase 5.  Prints
    per policy the retained sum per layer, the per-shard load max/mean
    (Eq. 4) under both plans, plan efficiency E, the graphed step's host
    and device time and kernel 1's device time per step.  Then phase 7's
    (b) configuration under headkv with obs on and off (identical tokens,
    no capture during either trace, Prometheus text and Chrome trace that
    parse, host-clocked tick medians), and (c)'s int8 pools with
    `plan_kv_dtypes` overrides.  Returns the launches of the phase."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, ObsConfig, PagingConfig, plan_kv_dtypes
    from repro_torch.compression.policies import BALANCED, _pyramid_budget, layer_keep_bound
    from repro_torch.configs.base import InputShape
    from repro_torch.core.profiles import profile_from_lengths
    from repro_torch.kernels import build
    from repro_torch.training.data import SyntheticLM

    m = ctx["cfg"].model
    L, H = m.n_layers, m.n_kv_heads
    data = SyntheticLM(m, InputShape("chip_smoke", T, B, "prefill"))
    sample = data.get_batch(123)["tokens"]
    prompts = ctx["prompts"]
    launches = {k: 0 for k in build.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    rows = {}
    for label, policy, with_imp in POLICY_RUNS:
        imp = ctx["profile"] if with_imp else None
        res, plans = {}, {}
        profile = eng = None
        for mode, ch in (("sha", 0), ("fairkv_dp", 4)):
            eng = None  # free the previous engine's slot weights and cache first
            gc.collect()
            torch.cuda.empty_cache()
            eng = Engine.build(_policy_config(ctx, policy, mode, ch), params=ctx["params"],
                               profile=ctx["profile"] if profile is None else profile,
                               head_importance=imp)
            if profile is None:  # the policy's own offline statistic
                profile, got = _count(lambda: eng.measure_profile(sample))
                add(got)
            teacher = None if mode == "sha" else res["sha"].tokens[:, :GEN]
            r, got = _count(lambda: eng.generate(prompts, GEN, teacher_tokens=teacher))
            add(got)
            if got["fairkv_decode"] != L * GEN or got["snapkv_scores"] != L:
                fail(f"{label} {mode}: launches {got}, expected {L * GEN} fairkv_decode and "
                     f"{L} snapkv_scores")
            if not np.isfinite(r.logits).all():
                fail(f"{label} {mode}: logits not finite")
            res[mode], plans[mode] = r, eng.plan
        sha, dp = res["sha"], res["fairkv_dp"]
        if not np.array_equal(sha.lengths, dp.lengths):
            fail(f"{label}: retained lengths differ between sha and fairkv_dp")
        lens = dp.lengths  # (L, Hkv, B)
        C = eng.cfg.compression.static_capacity()
        if policy in BALANCED:
            for layer in range(L):
                b = (_pyramid_budget(eng.cfg.compression, layer, L) if policy == "pyramidkv"
                     else BUDGET)
                if not (lens[layer] == min(b, T, C)).all():
                    fail(f"{label}: layer {layer} keeps {np.unique(lens[layer])}, expected "
                         f"exactly min({b}, {T}, {C})")
        per_layer = lens.sum(axis=1)  # (L, B)
        bounds = np.asarray([layer_keep_bound(policy, eng.cfg.compression, T, H, layer, L)
                             for layer in range(L)])
        if not (per_layer <= bounds[:, None]).all():
            worst = int((per_layer - bounds[:, None]).max())
            fail(f"{label}: a layer keeps {worst} tokens more than layer_keep_bound")
        tol = L * 2.0 ** -8 * float(np.abs(sha.logits).max())
        gap = float(np.abs(dp.logits - sha.logits).max())
        if not gap < tol:
            fail(f"{label}: fairkv_dp logits differ from sha's by {gap} >= {tol}")
        realized = profile_from_lengths(lens.astype(np.float64))
        load = {}
        for mode, plan in plans.items():
            per_shard = plan.per_shard_load(realized)
            load[mode] = float(per_shard.max() / per_shard.mean())
        dev_ms, k1_ms = _step_times(eng)
        host_ms = 1e3 * statistics.median(dp.step_s)
        rows[label] = {
            "retained_per_layer": per_layer.sum(axis=1).astype(int).tolist(),
            "retained_min_mean_max": [int(lens.min()), float(lens.mean()), int(lens.max())],
            "load_max_over_mean": load, "efficiency": {"sha": sha.efficiency,
                                                       "fairkv_dp": dp.efficiency},
            "step_ms_host": host_ms, "step_ms_device": dev_ms, "kernel1_ms_per_step": k1_ms,
            "prefill_s": dp.prefill_s, "logit_gap": gap, "logit_bound": tol,
            "keep_bound_slack_min": int((bounds[:, None] - per_layer).min())}
        log(f"[policy] {label:13s} retained per layer sum {per_layer.sum():8d} "
            f"(per-head min/mean/max {lens.min()}/{lens.mean():.1f}/{lens.max()}) | "
            f"load max/mean sha {load['sha']:.4f} fairkv_dp {load['fairkv_dp']:.4f} | "
            f"E sha {sha.efficiency:.4f} fairkv_dp {dp.efficiency:.4f} | step host "
            f"{host_ms:.2f} ms device {dev_ms:.2f} ms, kernel 1 {k1_ms:.4f} ms/step | "
            f"logit gap {gap:.4f} (bound {tol:.4f}) | keep bound slack >= "
            f"{rows[label]['keep_bound_slack_min']}")
        log(f"[policy] {label:13s} retained per layer: {rows[label]['retained_per_layer']}")
        eng = None
    log("[policy] summary " + json.dumps(rows))

    # phase 7's (b) under headkv, obs on and off
    import dataclasses
    comp = dataclasses.replace(ctx["cfg"].compression, policy="headkv")
    seen = {}

    def check_obs(eng, compiles_warm):
        seen["compiles"] = {k: eng.obs.metrics.counter_value(
            "stepfn_compiles_total", kind=k, executor="local") for k in compiles_warm}
        seen["warm"] = compiles_warm
        seen["prom"] = eng.metrics_prometheus()
        seen["trace"] = eng.trace_export()
        seen["families"] = sorted(eng.metrics())

    runs = {}
    for name, enabled in (("headkv obs on", True), ("headkv obs off", False)):
        seen.clear()
        got, runs[name] = continuous_run(
            ctx, name, "paged", "fp32", head_importance=ctx["profile"], inspect=check_obs,
            changes={"compression": comp, "obs": ObsConfig(enabled=enabled)})
        add(got)
        if enabled:
            if seen["compiles"] != seen["warm"] or sum(seen["warm"].values()) < 1:
                fail(f"{name}: stepfn_compiles_total {seen['compiles']} after the trace, "
                     f"{seen['warm']} after warmup")
            lines = [ln for ln in seen["prom"].splitlines() if not ln.startswith("#")]
            for ln in lines:
                float(ln.rsplit(" ", 1)[1])
            events = json.loads(seen["trace"])["traceEvents"]
            names = {e["name"] for e in events}
            if not {"admit", "decode_tick", "stepfn_decode", "retire"} <= names:
                fail(f"{name}: trace events {sorted(names)}")
            log(f"[policy] {name}: {len(lines)} Prometheus series, {len(events)} trace "
                f"events, families {seen['families']}; stepfn_compiles_total "
                f"{seen['compiles']} after the trace = after warmup")
    on, off = runs["headkv obs on"], runs["headkv obs off"]
    same = sum(x == y for x, y in zip(on["tokens"], off["tokens"]))
    log(f"[policy] headkv (b) obs on vs off: {same}/{N_REQ} requests identical; tick median "
        f"{on['step_ms_median']:.2f} vs {off['step_ms_median']:.2f} ms (host clock); "
        f"tokens/s {on['tokens_per_s']:.1f} vs {off['tokens_per_s']:.1f}")
    if same != N_REQ:
        fail(f"headkv obs on vs off: only {same}/{N_REQ} requests identical")

    # (c)'s int8 pools with per-head fp8 overrides from the measured profile
    overrides = plan_kv_dtypes(ctx["profile"])
    got, mixed = continuous_run(
        ctx, "int8+fp8 plan", "paged", "int8",
        changes={"paging": PagingConfig(block_size=BLOCK, kv_dtype="int8",
                                        kv_dtype_overrides=overrides)})
    add(got)
    log(f"[policy] (c) int8 with plan_kv_dtypes overrides: {len(overrides)} of {L * H} "
        f"(layer, head) cells in fp8; {mixed['finished']}/{N_REQ} finished, "
        f"tokens/s {mixed['tokens_per_s']:.1f}, tick median {mixed['step_ms_median']:.2f} ms")
    log("[policy] continuous summary " + json.dumps(
        {k: {kk: vv for kk, vv in v.items() if kk not in ("tokens", "logits")}
         for k, v in {**runs, "int8+fp8 plan": mixed}.items()}))
    log(f"[policy] launches over phase 12: {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 13: the serving CLI at full width
# ---------------------------------------------------------------------------


def cli_run():
    """Phase 13: ``python -m repro_torch.launch.serve`` at full width in a
    subprocess (continuous, headkv, paged pools, a few requests), writing
    its Prometheus metrics and Chrome trace under chiprun_out/.  Bars: exit
    0, and both files parse.  Then `cli_http_run`, the HTTP front end."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    metrics, trace = out_dir / "serve_metrics.prom", out_dir / "serve_trace.json"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--continuous",
           "--policy", "headkv", "--cache-backend", "paged", "--budget", str(BUDGET),
           "--requests", "6", "--rows", "4", "--rate", "0.5", "--min-prompt", "512",
           "--max-prompt", "1024", "--gen", "16", "--shards", str(N_SHARDS),
           "--metrics-out", str(metrics), "--trace-out", str(trace)]
    env = dict(__import__("os").environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=600)
    wall = time.perf_counter() - t0
    tail = "\n".join(proc.stdout.splitlines()[-8:])
    log(f"[cli] {' '.join(cmd[1:])}: exit {proc.returncode} in {wall:.1f} s\n{tail}")
    if proc.returncode != 0:
        fail(f"the serving CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = [ln for ln in metrics.read_text().splitlines() if not ln.startswith("#")]
    for ln in lines:
        float(ln.rsplit(" ", 1)[1])
    events = json.loads(trace.read_text())["traceEvents"]
    if not lines or not events:
        fail("the serving CLI wrote an empty metrics or trace file")
    log(f"[cli] {metrics.name}: {len(lines)} series; {trace.name}: {len(events)} events")
    cli_http_run(env)


def cli_http_run(env):
    """Phase 13, second subprocess: ``serve --http --port 0`` at full width
    on paged pools.  The script waits for the ``serving on`` line, sends two
    requests, then SIGTERM.  Bars: both requests finish with their tokens,
    exit 0, the drain line printed, ``--metrics-out`` parses and has the
    front end's families."""
    import queue
    import signal
    import threading
    import urllib.request
    out_dir = ROOT / "chiprun_out"
    metrics = out_dir / "serve_http_metrics.prom"
    cmd = [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH, "--http",
           "--port", "0", "--cache-backend", "paged", "--budget", str(BUDGET), "--rows", "4",
           "--min-prompt", "512", "--max-prompt", "1024", "--gen", "16", "--shards",
           str(N_SHARDS), "--metrics-out", str(metrics)]
    import numpy as np
    t0 = time.perf_counter()
    err_path = out_dir / "serve_http_stderr.txt"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=err,
                                text=True)
    lines: "queue.Queue[str]" = queue.Queue()
    reader = threading.Thread(target=lambda: [lines.put(ln) for ln in proc.stdout], daemon=True)
    reader.start()
    try:
        line = ""
        while not line.startswith("serving on"):
            try:
                line = lines.get(timeout=300)
            except queue.Empty:
                fail("serve --http printed no `serving on` line within 300 s")
        ready = time.perf_counter() - t0
        port = int(line.split("http://")[1].split()[0].rsplit(":", 1)[1])
        rng = np.random.default_rng(SEED)
        for i in range(2):
            body = json.dumps({"prompt": rng.integers(1, 256, size=600 + 100 * i).tolist(),
                               "max_new_tokens": 16, "tenant": f"cli{i}"}).encode()
            req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate", data=body,
                                         method="POST")
            out = json.loads(urllib.request.urlopen(req, timeout=120).read())
            if out["state"] != "finished" or len(out["tokens"]) != 16:
                fail(f"serve --http answered {out}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    reader.join(timeout=10)
    rest = []
    while not lines.empty():
        rest.append(lines.get())
    stdout = "".join(rest)
    log(f"[cli] {' '.join(cmd[1:])}: serving after {ready:.1f} s; exit {rc} in "
        f"{time.perf_counter() - t0:.1f} s\n{stdout.strip()}")
    if rc != 0:
        fail(f"serve --http exited {rc}: {err_path.read_text()[-2000:]}")
    if "drained after" not in stdout:
        fail("serve --http printed no drain line")
    text = metrics.read_text()
    series = [ln for ln in text.splitlines() if not ln.startswith("#")]
    for ln in series:
        float(ln.rsplit(" ", 1)[1])
    missing = [f for f in ("slo_attained_total", "goodput_tokens_total",
                           "frontend_admission_total") if f"{f}{{" not in text]
    if missing:
        fail(f"serve --http metrics lack {missing}")
    log(f"[cli] {metrics.name}: {len(series)} series")


# ---------------------------------------------------------------------------
# phase 14: the multi-tenant front end at full width
# ---------------------------------------------------------------------------

# a bursty three-tenant trace: batch sends 3x the others' traffic, bursts of
# 2x the rows every FE_GAP steps (fig10's shape, at phase 7's prompt sizes)
FE_N_REQ, FE_BURST, FE_GAP, FE_SEED = 48, 2 * MAX_ROWS, 10, 7
FE_MIX = {"interactive": 1.0, "standard": 1.0, "batch": 3.0}
FE_PRIO = {"interactive": 0, "standard": 1, "batch": 2}
# fig10's classes (benchmarks/fig10_goodput.py): every class has a step
# TTFT target, interactive and standard shed just past theirs, interactive
# may preempt, batch may degrade to 4 new tokens
FE_CLASSES = (dict(name="interactive", priority=0, ttft_slo_steps=24, shed_after_steps=28,
                   preempt_below=True),
              dict(name="standard", priority=1, ttft_slo_steps=48, shed_after_steps=52),
              dict(name="batch", priority=2, ttft_slo_steps=110, degrade_floor=4))
FE_FAMILIES = ("slo_attained_total", "slo_missed_total", "goodput_tokens_total",
               "frontend_ttft_steps_bucket", "frontend_itl_seconds_bucket",
               "frontend_admission_total", "frontend_rejections_total")


def frontend_engine(ctx):
    """Phase 7's configuration (b) with replanning off (as fig10 runs it):
    bf16 paged pools at worst-case size, fairkv_dp, Ada-SnapKV budget 256,
    8 rows, the same weights; a fresh engine, warmed up (its steps
    captured).  Returns (engine, the capture counts after warmup)."""
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig
    gc.collect()
    torch.cuda.empty_cache()
    cfg = ctx["cfg"].replace(cache_backend="paged", paging=PagingConfig(block_size=BLOCK),
                             scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    eng.warmup()
    return eng, _captures(eng)


def _captures(eng):
    """The executor's capture counts and ``stepfn_compiles_total`` per kind."""
    m = eng.obs.metrics
    return (dict(eng.executor.step_traces),
            {k: m.counter_value("stepfn_compiles_total", kind=k, executor="local")
             for k in eng.executor.step_traces})


def frontend_trace(vocab):
    """FE_N_REQ requests from `synthesize_requests` (seed FE_SEED) with the
    three-tenant mix, prompts of PROMPT_MIN-PROMPT_MAX tokens, NEW_MIN-NEW_MAX
    new tokens (a numpy generator of the same seed), re-timed into bursts."""
    import numpy as np
    from repro_torch.api import synthesize_requests
    reqs = synthesize_requests(FE_N_REQ, 1.0, vocab, min_prompt=PROMPT_MIN,
                               max_prompt=PROMPT_MAX, max_new_tokens=NEW_MAX, seed=FE_SEED,
                               tenant_mix=FE_MIX, tenant_priorities=FE_PRIO)
    gen = np.random.default_rng(FE_SEED).integers(NEW_MIN, NEW_MAX + 1, size=FE_N_REQ)
    for i, (r, g) in enumerate(zip(reqs, gen)):
        r.max_new_tokens = int(g)
        r.arrival_step = (i // FE_BURST) * FE_GAP
    return reqs


def _check_pool(name, sched):
    pool = sched.backend.pool
    pool.check_invariants()
    if pool.blocks_in_use() != 0:
        fail(f"{name}: {pool.blocks_in_use()} blocks still in use at the end")


def _check_no_capture(name, eng, warm):
    if _captures(eng) != warm:
        fail(f"{name}: captured during the run: {_captures(eng)} after warmup's {warm}")


def frontend_goodput(ctx, admission, launches):
    """(a) the trace through `run_frontend_trace` on a fresh engine under
    ``admission``.  Bars: every request terminal (finished, or rejected
    with a recorded reason), fcfs rejects none, the pool ends empty, no
    capture during the trace, and the kernels' launches match the run's
    prefills and decode ticks.  Returns the printed numbers."""
    import collections
    import numpy as np
    from repro_torch.frontend import (FrontendConfig, FrontendScheduler, PriorityClass,
                                      run_frontend_trace)
    eng, warm = frontend_engine(ctx)
    m = eng.cfg.model
    sched = eng._ensure_scheduler()
    fe = FrontendScheduler(sched, FrontendConfig(
        admission=admission, classes=tuple(PriorityClass(**c) for c in FE_CLASSES)))
    reqs = frontend_trace(m.vocab_size)
    pump, host = fe.pump, []

    def timed_pump():  # the front end's host time per tick outside Scheduler.step
        t0 = time.perf_counter()
        ev = pump()
        host.append(time.perf_counter() - t0 - sched.step_s[-1])
        return ev

    fe.pump = timed_pump
    out, got = _count(lambda: run_frontend_trace(fe, reqs, max_steps=3000))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    name = f"frontend {admission}"
    unreasoned = [r.req_id for r in reqs
                  if not r.is_finished or (r.cancelled and r.req_id not in fe.reject_reasons)]
    if not out["converged"] or unreasoned:
        fail(f"{name}: {out['finished']}/{FE_N_REQ} terminal; not terminal or cancelled "
             f"without a reason: {unreasoned}")
    if admission == "fcfs" and out["rejected"]:
        fail(f"{name}: fcfs rejected {out['rejected']} requests: {fe.reject_reasons}")
    _check_pool(name, sched)
    _check_no_capture(name, eng, warm)
    admissions = eng.obs.metrics.counter_value("sched_admissions_total")
    expect = {"paged_fairkv_decode": m.n_layers * sched.decode_ticks,
              "snapkv_scores": m.n_layers * int(admissions), "fairkv_decode": 0,
              "paged_fairkv_decode_mq": 0, "fairkv_decode_partial": 0}
    if got != expect:
        fail(f"{name}: launches {got}, expected {expect} ({sched.decode_ticks} decode ticks, "
             f"{admissions:.0f} admissions)")
    reasons = collections.Counter(fe.reject_reasons.values())
    row = {"steps": out["steps"], "decode_ticks": sched.decode_ticks,
           "goodput_tokens": out["goodput_tokens"],
           "goodput_tokens_per_step": out["goodput_tokens_per_step"],
           "generated_tokens": out["generated_tokens"], "slo_attainment": out["slo_attainment"],
           "attainment": {t: v["attainment"] for t, v in out["tenants"].items()},
           "p50_ttft_steps": {t: v["p50_ttft_steps"] for t, v in out["tenants"].items()},
           "rejections": dict(reasons),
           "degradations": sum(r.degraded_from is not None for r in reqs),
           "preemptions": out["preemptions"],
           "replay_swaps": eng.obs.metrics.counter_value("sched_replay_swaps_total"),
           "wall_s": out["wall_s"],
           "host_ms_per_pump_median": 1e3 * float(np.median(host)),
           "tick_ms_median": 1e3 * float(np.median(sched.step_s)), "launches": got}
    log(f"[frontend] {admission}: {out['finished']}/{FE_N_REQ} terminal, {out['rejected']} "
        f"rejected {dict(reasons)} | steps {out['steps']} (decode ticks {sched.decode_ticks}) "
        f"| goodput {out['goodput_tokens']:.0f} of {out['generated_tokens']:.0f} tokens = "
        f"{out['goodput_tokens_per_step']:.3f} per step | SLO attainment "
        f"{out['slo_attainment']:.3f}, per tenant {row['attainment']} | degradations "
        f"{row['degradations']} | preemptions {out['preemptions']} (replayed tokens kept over "
        f"what the replay computed: {row['replay_swaps']:.0f}) | front-end host time per "
        f"pump outside Scheduler.step: median {row['host_ms_per_pump_median']:.3f} ms (tick "
        f"median {row['tick_ms_median']:.2f} ms) | wall {out['wall_s']:.1f} s | launches {got}")
    del eng, fe, sched
    return row


async def _http(host, port, path, payload=None, method="POST"):
    """One HTTP/1.1 exchange (the server closes): (status, body bytes)."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    body = b"" if payload is None else json.dumps(payload).encode()
    writer.write(f"{method} {path} HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n\r\n"
                 .encode() + body)
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, data = raw.partition(b"\r\n\r\n")
    return int(head.split()[1]), data


async def _sse(host, port, payload, close_after=None):
    """An SSE stream: [(event type, data dict, arrival time)]; with
    ``close_after`` the client closes after that many token events."""
    import asyncio
    reader, writer = await asyncio.open_connection(host, port)
    body = json.dumps(payload).encode()
    writer.write(f"POST /v1/stream HTTP/1.1\r\nHost: x\r\nContent-Length: {len(body)}\r\n\r\n"
                 .encode() + body)
    await writer.drain()
    status = int((await reader.readline()).split()[1])
    if status != 200:
        fail(f"SSE route answered {status}")
    while (await reader.readline()) not in (b"\r\n", b""):
        pass
    events = []
    while True:
        block = (await reader.readuntil(b"\n\n")).decode().strip().split("\n")
        events.append((block[0][len("event: "):], json.loads(block[1][len("data: "):]),
                       time.perf_counter()))
        if events[-1][0] == "end" or (close_after is not None and sum(
                e[0] == "token" for e in events) >= close_after):
            break
    writer.close()
    return events


def _check_sse(name, events, want):
    """Contiguous indices, ``finished`` on the last token only, exactly one
    ``end`` event, last, whose tokens are the stream's."""
    toks = [e[1] for e in events if e[0] == "token"]
    if [e[0] for e in events] != ["token"] * len(toks) + ["end"]:
        fail(f"{name}: SSE event order {[e[0] for e in events]}")
    if [t["index"] for t in toks] != list(range(len(toks))):
        fail(f"{name}: SSE indices {[t['index'] for t in toks]}")
    if [t["finished"] for t in toks] != [False] * (len(toks) - 1) + [True]:
        fail(f"{name}: `finished` is not set on the last token only")
    if events[-1][1]["tokens"] != [t["token"] for t in toks]:
        fail(f"{name}: the end event's tokens differ from the streamed ones")
    if want is not None and [t["token"] for t in toks] != want:
        fail(f"{name}: SSE tokens differ from Engine.stream's")
    return [t["token"] for t in toks]


def frontend_http(ctx, launches):
    """(b) `FrontendServer` on 127.0.0.1, port 0, over a graphed engine
    (warmed up; `Engine.stream` of one prompt first, for the reference
    tokens), driven by an asyncio client in this process: (1) the prompt
    through /v1/generate and /v1/stream, (2) twelve concurrent requests
    over the three tenants, one SSE client closing after its third token,
    (3) a drain with requests live and queued, a request after it began.
    Bars: tokens equal to `Engine.stream`'s bitwise, SSE order, statuses
    by the reference's table, the cancelled request cancelled, the pool
    empty, no capture, /metrics parsing with the front end's families."""
    import asyncio
    import numpy as np
    from repro_torch.api import Request
    from repro_torch.frontend import FrontendConfig, FrontendServer, PriorityClass
    from repro_torch.frontend.http import _REJECT_STATUS
    eng, _ = frontend_engine(ctx)
    m = eng.cfg.model
    sched = eng._ensure_scheduler()
    rng = np.random.default_rng(FE_SEED + 1)
    one_gen = NEW_MAX // 2  # 1024 prompt tokens, 32 new ones
    prompt = rng.integers(1, m.vocab_size, size=PROMPT_MAX // 2).tolist()
    ref = [e.token for e in eng.stream([Request(req_id=10**6, prompt=np.asarray(
        prompt, np.int32), max_new_tokens=one_gen)])]
    warm = _captures(eng)
    tenants = list(FE_PRIO)
    asks = [dict(prompt=rng.integers(1, m.vocab_size, size=int(rng.integers(
        PROMPT_MIN, PROMPT_MAX + 1))).tolist(), max_new_tokens=int(rng.integers(
            NEW_MIN, NEW_MAX + 1)), tenant=tenants[i % 3], priority=FE_PRIO[tenants[i % 3]])
            for i in range(22)]
    asks[0]["max_new_tokens"] = NEW_MAX  # the client that leaves after 3 tokens
    server = FrontendServer(eng, FrontendConfig(
        port=0, classes=tuple(PriorityClass(**c) for c in FE_CLASSES),
        max_prompt_tokens=PROMPT_MAX, max_new_tokens_cap=NEW_MAX))

    async def one(ask, i):
        if i % 2 == 0:
            ev = await _sse(server.host, server.port, ask, close_after=3 if i == 0 else None)
            end = ev[-1][1] if ev[-1][0] == "end" else None
            return ("sse", ev, end)
        status, data = await _http(server.host, server.port, "/v1/generate", ask)
        return ("json", status, json.loads(data))

    def all_tokens(end, ask):
        """Every token asked, or fewer after a degradation of that ask."""
        n = len(end["tokens"])
        if end["degraded_from"] is None:
            return n == ask["max_new_tokens"]
        return end["degraded_from"] == ask["max_new_tokens"] and n < ask["max_new_tokens"]

    def check_outcome(i, ask, res):
        """A finished request has its tokens; any other ends with the
        reference's status for its reason (SSE: a recorded reason); the
        client that left has no end event."""
        if res[0] == "sse":
            end = res[2]
            if end is None:
                return i == 0
            if end["state"] == "finished":
                _check_sse(f"request {i}", res[1], None)
                return all_tokens(end, ask)
            return bool(end["reason"])
        _, status, out = res
        if status == 200:
            return out["state"] == "finished" and all_tokens(out, ask)
        return status == _REJECT_STATUS.get(out["reason"], 422)

    async def session():
        await server.start()
        try:
            h, p = server.host, server.port
            # 1. one prompt, JSON then SSE
            payload = {"prompt": prompt, "max_new_tokens": one_gen, "tenant": "interactive",
                       "priority": 0}
            status, data = await _http(h, p, "/v1/generate", payload)
            out = json.loads(data)
            if status != 200 or out["tokens"] != ref:
                fail(f"/v1/generate: {status}, tokens equal to Engine.stream's: "
                     f"{out.get('tokens') == ref}")
            _check_sse("one prompt", await _sse(h, p, payload), ref)
            # 2. twelve concurrent requests over three tenants
            n0 = len(sched.step_s)
            t0 = time.perf_counter()
            res = await asyncio.gather(*[one(a, i) for i, a in enumerate(asks[:12])])
            wall = time.perf_counter() - t0
            ticks = sched.step_s[n0:]
            bad = [i for i, (a, r) in enumerate(zip(asks, res)) if not check_outcome(i, a, r)]
            if bad:
                fail(f"concurrent requests {bad} ended wrongly: {[res[i] for i in bad]}")
            cut_id = res[0][1][0][1]["req_id"]
            # 3. drain with requests live and queued; one sent after it began
            late = [asyncio.create_task(one(a, 2 * i + 1)) for i, a in enumerate(asks[12:])]
            fe = server.engine_loop.fe

            async def until(cond):
                while not cond():
                    await asyncio.sleep(0.002)
            await asyncio.wait_for(until(lambda: len(fe.sched.active) == MAX_ROWS
                                         and len(fe.queue) > 0), 120)
            drained = asyncio.get_running_loop().run_in_executor(
                None, server.engine_loop.drain, 300.0)
            await asyncio.wait_for(until(lambda: server.engine_loop.draining), 60)
            status, data = await _http(h, p, "/v1/generate", asks[0])
            if status != 503:
                fail(f"a request after the drain began got {status}, not 503")
            if not await drained:
                fail("the drain did not finish")
            late_res = await asyncio.gather(*late)
            done = [r[2]["state"] for r in late_res]
            if done.count("finished") < MAX_ROWS or any(
                    r[2]["state"] != "finished" and r[2]["reason"] != "draining"
                    for r in late_res):
                fail(f"drain: outcomes {[(r[1], r[2]['state'], r[2]['reason']) for r in late_res]}")
            status, prom = await _http(h, p, "/metrics", method="GET")
            return res, wall, ticks, cut_id, late_res, prom.decode()
        finally:
            await server.shutdown(drain=True)

    (res, wall, ticks, cut_id, late_res, prom), got = _count(lambda: asyncio.run(session()))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    fe = server.engine_loop.fe
    if server.engine_loop.error is not None:
        fail(f"the engine loop failed: {server.engine_loop.error!r}")
    cut = next(r for r in fe.finished if r.req_id == cut_id)
    if not cut.cancelled or fe.sched.n_cancellations < 1:
        fail(f"the request whose client left is {cut.state.value}, not cancelled")
    _check_pool("frontend http", sched)
    _check_no_capture("frontend http", eng, warm)
    lines = [ln for ln in prom.splitlines() if ln and not ln.startswith("#")]
    for ln in lines:
        float(ln.rsplit(" ", 1)[1])
    missing = [f for f in FE_FAMILIES if f"{f}{{" not in prom]
    if missing:
        fail(f"/metrics lacks {missing}")
    if got["snapkv_scores"] == 0 or got["paged_fairkv_decode"] == 0 or got["fairkv_decode"]:
        fail(f"frontend http: launches {got}")
    ttft = {}
    for r in fe.finished:  # the HTTP requests (not the reference stream's)
        if r.tenant in FE_PRIO and not r.cancelled and r.ttft_seconds() is not None:
            ttft.setdefault(r.tenant, []).append(r.ttft_seconds())
    gaps = [b[2] - a[2] for kind, ev, _ in (x for x in res if x[0] == "sse")
            for a, b in zip(ev, ev[1:]) if a[0] == b[0] == "token"]
    row = {"ttft_s": {t: {"p50": float(np.percentile(v, 50)), "p99": float(np.percentile(v, 99)),
                          "n": len(v)} for t, v in sorted(ttft.items())},
           "sse_gap_ms_p50": 1e3 * float(np.median(gaps)),
           "tick_ms_median": 1e3 * float(np.median(ticks)), "wall_s_12": wall,
           "statuses": sorted(_outcome(r) for r in res),
           "drain": [(r[2]["state"], r[2]["reason"]) for r in late_res],
           "prometheus_series": len(lines), "cancelled_req": cut_id,
           "cancelled_after_tokens": cut.n_generated, "launches": got,
           "preempted": sum(r.n_preemptions > 0 for r in fe.finished),
           "replay_swaps": eng.obs.metrics.counter_value("sched_replay_swaps_total")}
    log(f"[frontend] http: one prompt via JSON and SSE = Engine.stream's {len(ref)} tokens; 12 "
        f"concurrent requests in {wall:.2f} s, outcomes {row['statuses']}; the client that left "
        f"after 3 tokens: request {cut_id} cancelled at {cut.n_generated} tokens; drain "
        f"outcomes {row['drain']}, late request 503 | TTFT per tenant (s) "
        + ", ".join(f"{t} p50 {v['p50']:.3f} p99 {v['p99']:.3f} (n {v['n']})"
                    for t, v in row["ttft_s"].items())
        + f" | SSE inter-token gap p50 {row['sse_gap_ms_p50']:.2f} ms vs tick median "
        f"{row['tick_ms_median']:.2f} ms | /metrics {len(lines)} series with "
        f"{len(FE_FAMILIES)} front-end families | pool empty, no capture | {row['preempted']} "
        f"requests preempted, {row['replay_swaps']:.0f} replayed tokens kept over what the "
        f"replay computed | launches {got}")
    del eng, server
    return row


def _outcome(res):
    """A client's result in a word: the JSON status, or the SSE end state
    (``left`` for the client that closed early)."""
    if res[0] == "json":
        return str(res[1])
    return "sse " + (res[2]["state"] if res[2] is not None else "left")


def frontend_runs(ctx):
    """Phase 14: (a) goodput under slo and fcfs, (b) HTTP in process.
    Returns the phase's kernel launches."""
    launches = {}
    t0 = time.perf_counter()
    rows = {adm: frontend_goodput(ctx, adm, launches) for adm in ("slo", "fcfs")}
    rows["http"] = frontend_http(ctx, launches)
    log(f"[frontend] summary {json.dumps(rows)}")
    log(f"[frontend] phase 14 took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 10: timings on the main path's inputs
# ---------------------------------------------------------------------------


def time_ms(fn, flush, iters=25, warmup=5):
    """Median device time of ``fn`` in ms (CUDA events), L2 flushed before
    each run.  A ~1 ms device sleep sits between the flush and the start
    event, so the host has enqueued all of ``fn`` before the device reaches
    the start event: the time is the device's, without the wrapper's host
    time (which `host_us` reports)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(iters):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        ts.append(a.elapsed_time(b))
    return statistics.median(ts)


def host_us(fn, n=100):
    """Host time per call of ``fn`` in us: ``n`` calls enqueued back to
    back (the device's work is not waited for)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / n


def _scores_bound(q, k, opos, kpos):
    """(bytes, FLOP, bound ms) of snapkv_scores on these inputs: q and K
    read once, the positions, the fp32 output written once; the score
    contraction's FLOP at the bf16 tensor-core peak."""
    Bq, W, Hq, Dh = q.shape
    Tk, Hkv = k.shape[1], k.shape[2]
    nbytes = (k.numel() + q.numel()) * k.element_size() + (opos.numel() + kpos.numel()) * 4 \
        + Bq * Hkv * Tk * 4
    flops = 2 * Bq * Hq * W * Tk * Dh
    return nbytes, flops, 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)


def time_kernels(engine, launches, paged, mq_inputs, prefix):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.ref import fairkv_decode_ref, snapkv_scores_ref
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")  # > 50 MB L2
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 1)
    m = engine.cfg.model
    rows = []

    # kernel 1 on layer 0 of the fairkv_dp engine's cache after decode
    cache = engine.state.cache
    k, v, ln = cache.k[0], cache.v[0], cache.lengths[0]
    S, Bq, C, Dh = k.shape
    G = m.q_per_kv
    q = torch.randn((Bq, S, G, Dh), generator=gen, device="cuda").to(k.dtype)
    out = fairkv_decode_cuda(q, k, v, ln)
    ref = fairkv_decode_ref(q, k, v, ln)
    err = _cmp("fairkv_decode (main-path cache)", out, ref, FP32_TOL, BF16_ULP)
    qs = q.permute(1, 0, 2, 3).reshape(S * Bq, G, 1, Dh)
    ks = k.reshape(S * Bq, 1, C, Dh)
    vs = v.reshape(S * Bq, 1, C, Dh)
    mask = (torch.arange(C, device="cuda")[None, :] < ln.reshape(-1, 1))[:, None, None, :]
    kern = time_ms(lambda: fairkv_decode_cuda(q, k, v, ln), flush)
    plain = time_ms(lambda: fairkv_decode_ref(q, k, v, ln), flush)
    lib = time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                           enable_gqa=True), flush)
    it = k.element_size()
    n_ret = int(ln.sum().item())
    bytes1 = (n_ret * Dh * 2 * it + 2 * q.numel() * it + ln.numel() * 4)
    flops1 = 4 * n_ret * G * Dh
    bound1 = 1e3 * max(bytes1 / HBM_BYTES_PER_S, flops1 / BF16_FLOP_PER_S)
    rows.append({"name": "fairkv_decode", "route": "cuda",
                 "source": "src/repro_torch/csrc/fairkv_decode.cu",
                 "replaces": "src/repro/kernels/fairkv_decode.py:107",
                 "launches": launches["fairkv_decode"], "max_abs_err": err,
                 "ms": kern, "plain_ms": plain, "bound_ms": bound1,
                 "bound_by": "bytes" if bytes1 / HBM_BYTES_PER_S >= flops1 / BF16_FLOP_PER_S
                 else "operations",
                 "library_ms": lib})
    host_kern = host_us(lambda: fairkv_decode_cuda(q, k, v, ln))
    host_lib = host_us(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                              enable_gqa=True))
    log(f"[time] fairkv_decode at (B={Bq}, S={S}, G={G}, C={C}, Dh={Dh}) bf16, "
        f"sum(lengths)={n_ret}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
        f"SDPA {lib:.4f} ms, bound {bound1:.4f} ms ({bytes1} B / 3.35 TB/s); host time "
        f"per call: kernel {host_kern:.1f} us, SDPA {host_lib:.1f} us")

    # kernel 2 at prefill's shape: q_obs (B, W, Hq, Dh), k (B, T, Hkv, Dh)
    q2 = torch.randn((B, OBS, m.n_heads, Dh), generator=gen, device="cuda").to(k.dtype)
    k2 = torch.randn((B, T, m.n_kv_heads, Dh), generator=gen, device="cuda").to(k.dtype)
    kpos = torch.arange(T, dtype=torch.int32, device="cuda").expand(B, T).contiguous()
    opos = kpos[:, T - OBS:].contiguous()
    out2 = snapkv_scores_cuda(q2, k2, opos, kpos)
    ref2 = snapkv_scores_ref(q2, k2, opos, kpos)
    err2 = _cmp("snapkv_scores (main-path shape)", out2, ref2, FP32_TOL, 1e-5)
    kern2 = time_ms(lambda: snapkv_scores_cuda(q2, k2, opos, kpos), flush)
    plain2 = time_ms(lambda: snapkv_scores_ref(q2, k2, opos, kpos), flush)
    bytes2, flops2, bound2 = _scores_bound(q2, k2, opos, kpos)
    rows.append({"name": "snapkv_scores", "route": "cuda",
                 "source": "src/repro_torch/csrc/snapkv_scores.cu",
                 "replaces": "src/repro/kernels/snapkv_select.py:89",
                 "launches": launches["snapkv_scores"], "max_abs_err": err2,
                 "ms": kern2, "plain_ms": plain2, "bound_ms": bound2,
                 "bound_by": "bytes" if bytes2 / HBM_BYTES_PER_S >= flops2 / BF16_FLOP_PER_S
                 else "operations",
                 "library_ms": None})
    log(f"[time] snapkv_scores at (B={B}, W={OBS}, Hq={m.n_heads}, Hkv={m.n_kv_heads}, "
        f"Dh={Dh}, T={T}) bf16: kernel {kern2:.4f} ms, plain {plain2:.4f} ms, "
        f"bound {bound2:.4f} ms (max of {bytes2} B / 3.35 TB/s and {flops2} FLOP / "
        f"989 TFLOP/s; {flops2 / FP32_FLOP_PER_S * 1e3:.4f} ms at the fp32 CUDA-core peak); "
        f"host time per call {host_us(lambda: snapkv_scores_cuda(q2, k2, opos, kpos)):.1f} us")
    # and at B = 1, the continuous scheduler's admission prefill of T tokens
    q1, k1, op1, kp1 = (x[:1].contiguous() for x in (q2, k2, opos, kpos))
    err_b1 = _cmp("snapkv_scores (B=1)", snapkv_scores_cuda(q1, k1, op1, kp1),
                  snapkv_scores_ref(q1, k1, op1, kp1), FP32_TOL, 1e-5)
    kern_b1 = time_ms(lambda: snapkv_scores_cuda(q1, k1, op1, kp1), flush)
    plain_b1 = time_ms(lambda: snapkv_scores_ref(q1, k1, op1, kp1), flush)
    bytes_b1, _, bound_b1 = _scores_bound(q1, k1, op1, kp1)
    rows[-1].update(ms_b1=kern_b1, plain_ms_b1=plain_b1, bound_ms_b1=bound_b1)
    log(f"[time] snapkv_scores at (B=1, W={OBS}, Hq={m.n_heads}, Hkv={m.n_kv_heads}, "
        f"Dh={Dh}, T={T}) bf16: kernel {kern_b1:.4f} ms, plain {plain_b1:.4f} ms, "
        f"bound {bound_b1:.4f} ms ({bytes_b1} B / 3.35 TB/s); max abs err {err_b1:.3e}")
    # and at the chunk shape of chunked prefill: a full chunk of CHUNK keys
    # at positions from 1024, the last OBS queries
    qc, kc, opc, kpc = chunk_scores_inputs(gen, OBS, m.n_heads, m.n_kv_heads, Dh, CHUNK,
                                           1024, CHUNK, k.dtype)
    err_c = _cmp("snapkv_scores (chunk shape)", snapkv_scores_cuda(qc, kc, opc, kpc),
                 snapkv_scores_ref(qc, kc, opc, kpc), FP32_TOL, 1e-5)
    kern_c = time_ms(lambda: snapkv_scores_cuda(qc, kc, opc, kpc), flush)
    plain_c = time_ms(lambda: snapkv_scores_ref(qc, kc, opc, kpc), flush)
    bytes_c, flops_c, bound_c = _scores_bound(qc, kc, opc, kpc)
    rows[-1].update(ms_chunk=kern_c, plain_ms_chunk=plain_c, bound_ms_chunk=bound_c,
                    max_abs_err_chunk=err_c, launches_chunk_phase=prefix["snapkv_scores"])
    log(f"[time] snapkv_scores at the chunk shape (B=1, W={OBS}, Hq={m.n_heads}, "
        f"Hkv={m.n_kv_heads}, Dh={Dh}, T={CHUNK}, positions from 1024) bf16: kernel "
        f"{kern_c:.4f} ms, plain {plain_c:.4f} ms, bound {bound_c:.4f} ms (max of {bytes_c} B "
        f"/ 3.35 TB/s and {flops_c} FLOP / 989 TFLOP/s); max abs err {err_c:.3e}; "
        f"{prefix['snapkv_scores']} launches in the chunked / prefix phase")

    # kernel 3 on layer 0 of the paged caches after the one-shot decode
    # (bf16 pools; int8 pools beside them)
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_cuda
    from repro_torch.kernels.ref import paged_fairkv_decode_ref
    C = int(round(ALPHA * BUDGET)) + MARGIN
    row = {"name": "paged_fairkv_decode", "route": "cuda",
           "source": "src/repro_torch/csrc/paged_fairkv_decode.cu",
           "replaces": "src/repro/kernels/paged_fairkv_decode.py:326",
           "launches": launches["paged_fairkv_decode"], "library_ms": None}
    for name in ("bf16", "int8"):
        t = paged[name]
        tbl, ln = t["table"], t["lengths"]
        S, Bq, M = tbl.shape
        q3 = torch.randn((Bq, S, G, Dh), generator=gen, device="cuda").to(torch.bfloat16)
        kw = {}
        if name == "int8":
            kinds = torch.zeros((S,), dtype=torch.int32, device="cuda")
            kw = dict(k_scale=t["k_scale"], v_scale=t["v_scale"], kinds=kinds)
        args = (q3, t["k_pool"], t["v_pool"], t["pos_pool"], tbl, ln, C)
        out3 = paged_fairkv_decode_cuda(*args, **kw)
        ref3 = paged_fairkv_decode_ref(*args, **kw)
        err3 = _cmp_paged(f"paged_fairkv_decode ({name} pools, main-path cache)", out3, ref3)
        kern3 = time_ms(lambda: paged_fairkv_decode_cuda(*args, **kw), flush)
        plain3 = time_ms(lambda: paged_fairkv_decode_ref(*args, **kw), flush)
        # bytes this data needs: the K and V rows of the retained columns,
        # the table entries and (int8) the two scales of each valid block,
        # q, out, lengths; operations: q.k and p.v per retained column
        n_ret = int(ln.sum().item())
        n_blk = int(((ln + BLOCK - 1) // BLOCK).sum().item())
        it3 = t["k_pool"].element_size()
        bytes3 = (n_ret * Dh * 2 * it3 + n_blk * 4 + (n_blk * 8 if kw else 0)
                  + 2 * q3.numel() * 2 + ln.numel() * 4)
        flops3 = 4 * n_ret * G * Dh
        bound3 = 1e3 * max(bytes3 / HBM_BYTES_PER_S, flops3 / BF16_FLOP_PER_S)
        sfx = "" if name == "bf16" else "_int8"
        row.update({f"max_abs_err{sfx}": err3, f"ms{sfx}": kern3, f"plain_ms{sfx}": plain3,
                    f"bound_ms{sfx}": bound3})
        if name == "bf16":
            row["bound_by"] = ("bytes" if bytes3 / HBM_BYTES_PER_S >= flops3 / BF16_FLOP_PER_S
                               else "operations")
        log(f"[time] paged_fairkv_decode, {name} pools, at (B={Bq}, S={S}, G={G}, Dh={Dh}, "
            f"bs={BLOCK}, M={M}), sum(lengths)={n_ret} in {n_blk} blocks: kernel "
            f"{kern3:.4f} ms, plain {plain3:.4f} ms, bound {bound3:.4f} ms "
            f"({bytes3} B / 3.35 TB/s); no single PyTorch call reads a block table")
    rows.append(row)

    # kernel 4 on the inputs of layer 0 at a verify tick of (e) (Q = 5)
    from repro_torch.kernels.paged_fairkv_decode import paged_fairkv_decode_mq_cuda
    args, kw = mq_inputs["args"], mq_inputs["kw"]
    q4, tbl, ln = args[0], args[4], args[5]
    Bq, S, Q, G, Dh = q4.shape
    out4 = paged_fairkv_decode_mq_cuda(*args, **kw)
    ref4 = paged_fairkv_decode_ref(*args, **kw)
    err4 = _cmp("paged_fairkv_decode_mq (main-path verify inputs)", out4, ref4,
                FP32_TOL, BF16_ULP)
    kern4 = time_ms(lambda: paged_fairkv_decode_mq_cuda(*args, **kw), flush)
    plain4 = time_ms(lambda: paged_fairkv_decode_ref(*args, **kw), flush)
    # bytes this data needs: the K and V rows of the retained columns (every
    # column below len is visible to the window's last query), the table
    # entries of the valid blocks, q, out, lengths, q_lens; operations:
    # q.k and p.v for each (query, visible column) pair
    n_ret = int(ln.sum().item())
    n_blk = int(((ln + BLOCK - 1) // BLOCK).sum().item())
    it4 = args[1].element_size()
    qn = kw["q_lens"].long()[:, None, None]  # (B, 1, 1)
    lnT = ln.T.long()[:, :, None]  # (B, S, 1)
    vis = torch.clamp(torch.minimum(lnT - (qn - 1 - torch.arange(Q, device="cuda")), lnT),
                      min=0)
    n_vis = int(vis.sum().item())
    bytes4 = (n_ret * Dh * 2 * it4 + n_blk * 4 + 2 * q4.numel() * q4.element_size()
              + ln.numel() * 4 + Bq * 4)
    flops4 = 4 * n_vis * G * Dh
    bound4 = 1e3 * max(bytes4 / HBM_BYTES_PER_S, flops4 / BF16_FLOP_PER_S)
    rows.append({"name": "paged_fairkv_decode_mq", "route": "cuda",
                 "source": "src/repro_torch/csrc/paged_fairkv_decode_mq.cu",
                 "replaces": "src/repro/kernels/paged_fairkv_decode.py:238",
                 "launches": launches["paged_fairkv_decode_mq"], "max_abs_err": err4,
                 "ms": kern4, "plain_ms": plain4, "bound_ms": bound4,
                 "bound_by": "bytes" if bytes4 / HBM_BYTES_PER_S >= flops4 / BF16_FLOP_PER_S
                 else "operations",
                 "library_ms": None})
    log(f"[time] paged_fairkv_decode_mq, bf16 pools, verify inputs of layer 0 at (B={Bq}, "
        f"S={S}, Q={Q}, G={G}, Dh={Dh}, bs={BLOCK}), q_lens {kw['q_lens'].tolist()}, "
        f"sum(lengths)={n_ret} in {n_blk} blocks, {n_vis} visible (query, column) pairs: "
        f"kernel {kern4:.4f} ms, plain {plain4:.4f} ms, bound {bound4:.4f} ms ({bytes4} B / "
        f"3.35 TB/s; {flops4} FLOP); no single PyTorch call reads a block table")
    return rows


# ---------------------------------------------------------------------------
# phase 11: after the timings
# ---------------------------------------------------------------------------


def oneshot_beside_scheduler(ctx):
    """Phase 11: one engine serving one-shot and continuous at once, graphed
    against an eager twin driven alike (fairkv_dp, slot backend, 8
    scheduler rows: the one-shot state and the scheduler's share a layout,
    and each gets a decode graph of its own).  Each engine: generate, a
    one-shot replan to the flipped profile, generate, `warmup`, then the
    first 4 requests of `make_trace` with a generate after tick 4.  Holds
    the graphed engine to the eager one (one-shot tokens, the logit gap
    within phase 5's bf16 bound, trace tokens), the first generate to phase 5's tokens, and the
    captures to one decode graph per live state, unmoved by the replan,
    the ticks and the later generates."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, SchedulerConfig
    from repro_torch.serving.engine import state_layout
    cfg = ctx["cfg"].replace(scheduler=SchedulerConfig(max_rows=B))
    flipped = np.ascontiguousarray(ctx["profile"][:, ::-1])
    runs = {}
    for label in ("graphs", "eager"):
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
        if label == "eager":
            eng.executor = eager_executor(cfg)
        ex = eng.executor
        gen = lambda: eng.generate(ctx["prompts"], GEN, teacher_tokens=ctx["teacher"])  # noqa: E731
        outs = [gen()]
        captured = dict(ex.step_traces)
        eng.replan(profile=flipped)
        outs.append(gen())
        eng.warmup()
        shared = state_layout(eng._live) == state_layout(eng.scheduler.state)
        reqs = make_trace(cfg.model.vocab_size)[:4]
        for ev in eng.stream(reqs):
            if ev.step >= 4 and len(outs) == 2:
                outs.append(gen())
        if not all(r.is_finished for r in reqs):
            fail(f"one-shot beside the scheduler ({label}): a request did not finish")
        runs[label] = dict(outs=outs, reqs=reqs, captured=captured,
                           traces=dict(ex.step_traces), shared=shared)
        del eng, ex
    g, e = runs["graphs"], runs["eager"]
    tol = cfg.model.n_layers * 2.0 ** -8 * float(np.abs(e["outs"][0].logits).max())
    gaps = [float(np.abs(a.logits - b.logits).max()) for a, b in zip(g["outs"], e["outs"])]
    same_oneshot = all(np.array_equal(a.tokens, b.tokens) for a, b in zip(g["outs"], e["outs"]))
    same_trace = sum(a.generated == b.generated for a, b in zip(g["reqs"], e["reqs"]))
    as_phase5 = np.array_equal(g["outs"][0].tokens, ctx["slot_dp"].tokens)
    log(f"[mixed] one engine, one-shot beside continuous: the two states share a layout "
        f"{g['shared']}; graphs vs eager: one-shot tokens identical {same_oneshot}, max "
        f"|logit gap| per generate {gaps} (bound {tol:.4f}), trace "
        f"{same_trace}/4 requests identical; first generate equal to phase 5's {as_phase5}; "
        f"captures after the first generate {g['captured']}, at the end {g['traces']}")
    if not g["shared"]:
        fail("the one-shot and scheduler states differ in layout: the check would not "
             "exercise one executor serving two states of one shape")
    if not same_oneshot or not max(gaps) < tol or same_trace != 4:
        fail("one-shot beside the scheduler: the graphed engine differs from the eager one")
    if not as_phase5:
        fail("one-shot beside the scheduler: the first generate differs from phase 5's")
    if g["captured"]["decode"] != 1 or g["traces"] != dict(g["captured"], decode=2):
        fail(f"captures {g['traces']}, expected {g['captured']} plus the scheduler's decode graph")


# ---------------------------------------------------------------------------
# phase 15: the multi-GPU executor
# ---------------------------------------------------------------------------

MESH_REQS = 8  # the first requests of phase 7's trace
MESH_CHUNK_REQS, MESH_CHUNK = 4, 256  # (a)'s chunked run: prompts of 512+ tokens


def _checksum(params):
    """One float64 sum per leaf of a parameter tree (device reductions: the
    same bits give the same sums)."""
    import torch

    def leaves(t):
        if torch.is_tensor(t):
            return [t]
        if isinstance(t, dict):
            return [x for v in t.values() for x in leaves(v)]
        if isinstance(t, (list, tuple)):
            return [x for v in t for x in leaves(v)]
        return []

    return [float(torch.sum(t, dtype=torch.float64)) for t in leaves(params)]


def _per_step(ex, kind):
    """(steps, {group: {collective: {calls, bytes}}} per step) of ``kind``."""
    from repro_torch.distributed import comm
    n = ex.step_calls[kind]
    per = comm.by_kind(ex.step_collectives[kind])
    return n, {g: {c: {f: v[f] / max(n, 1) for f in ("calls", "bytes")}
                   for c, v in d.items()} for g, d in per.items()}


def _check_contract(name, n, per, n_reduce):
    """The decode contract of ``n`` steps with collectives ``per`` per step
    (`_per_step`): ``n_reduce`` all-reduces over model (one per layer the
    step runs: every layer for decode and verify, draft layers x max_k for
    a propose) and no all-gather."""
    model = per.get("model", {})
    if n == 0 or model.get("all_reduce", {}).get("calls") != n_reduce or "all_gather" in model:
        fail(f"{name}: {n} steps with collectives {per} per step; expected {n_reduce} "
             f"all-reduces over model and no all-gather")


def mesh_nccl(ctx):
    """Phase 15 (a): one NCCL rank, graphed, at full width.  Returns what
    (b) compares with and the phase's launches."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.api import Engine, PrefixConfig, SpeculationConfig
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import make_host_mesh
    m = ctx["cfg"].model
    t0 = time.perf_counter()
    launches = {k: 0 for k in build.LAUNCHES}

    def add(got):
        for k, v in got.items():
            launches[k] += v

    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(ctx["cfg"].replace(executor="mesh"), mesh=mesh,
                           params=ctx["params"], profile=ctx["profile"])
        res, got = _count(lambda: eng.generate(ctx["prompts"], GEN,
                                               teacher_tokens=ctx["teacher"]))
        add(got)
        ref, ex = ctx["slot_dp"], eng.executor
        for key in ("tokens", "logits", "lengths"):
            if not np.array_equal(getattr(res, key), getattr(ref, key)):
                fail(f"[mesh] (a) one-shot fairkv_dp: {key} differ from the local executor's "
                     f"(max |diff| {float(np.abs(getattr(res, key) - getattr(ref, key)).max())})")
        if ex.step_traces["decode"] != 1 or got["fairkv_decode"] != m.n_layers * GEN:
            fail(f"[mesh] (a) captures {ex.step_traces}, launches {got}")
        n, per = _per_step(ex, "decode")
        _check_contract("[mesh] (a) one-shot decode", n, per, m.n_layers)
        step_ms = 1e3 * statistics.median(res.step_s)
        log(f"[mesh] (a) one NCCL rank, fairkv_dp one-shot: tokens, logits and lengths bitwise "
            f"the local executor's (phase 5); decode captured once, replayed "
            f"{ex.replays['decode']} times; per decode step "
            f"{per['model']['all_reduce']['calls']:.0f} all-reduces over model "
            f"({per['model']['all_reduce']['bytes']:.0f} B), no all-gather; step median "
            f"{step_ms:.2f} ms vs the local executor's "
            f"{1e3 * statistics.median(ref.step_s):.2f} ms; launches {got}")
        out = {"oneshot_step_ms": step_ms, "oneshot_local_step_ms":
               1e3 * statistics.median(ref.step_s), "decode_per_step": per}
        eng = res = None
        gc.collect()
        torch.cuda.empty_cache()

        stats = {}

        def keep(tag):
            def inspect(e, warm):
                ex = e.executor
                for kind in ("decode", "propose", "verify", "prefill_chunk"):
                    if ex.step_calls[kind]:
                        stats[(tag, kind)] = _per_step(ex, kind)
                stats[(tag, "captures")] = dict(ex.step_traces)
            return inspect

        def reqs(n=MESH_REQS):
            return make_trace(m.vocab_size)[:n]

        chunk = {"prefix": PrefixConfig(enabled=False, chunk_tokens=MESH_CHUNK)}
        pairs = (("(b)", None, None, MESH_REQS), ("(e)", SpeculationConfig(**SPEC_E), None,
                                                  MESH_REQS),
                 ("chunked", None, chunk, MESH_CHUNK_REQS))
        for tag, spec, changes, n_req in pairs:
            _, loc = continuous_run(ctx, f"local {tag}", "paged", "fp32", spec=spec,
                                    changes=changes, reqs=reqs(n_req))
            got, msh = continuous_run(ctx, f"mesh {tag}", "paged", "fp32", spec=spec,
                                      changes=changes, reqs=reqs(n_req), mesh=mesh,
                                      inspect=keep(tag))
            add(got)
            if msh["tokens"] != loc["tokens"]:
                same = sum(x == y for x, y in zip(msh["tokens"], loc["tokens"]))
                fail(f"[mesh] (a) {tag}: {same}/{n_req} requests with the local tokens")
            if tag == "(b)":
                out["trace_tokens"] = loc["tokens"]
                out["trace_local_tokens_per_s"] = loc["tokens_per_s"]
            log(f"[mesh] (a) {tag} on bf16 pools, first {n_req} requests of phase 7's trace: "
                f"tokens bitwise the local executor's; tokens/s {msh['tokens_per_s']:.1f} "
                f"(local {loc['tokens_per_s']:.1f}); tick median {msh['step_ms_median']:.2f} ms "
                f"(local {loc['step_ms_median']:.2f} ms); captures {stats[(tag, 'captures')]}")
        ex_ok = stats[("(e)", "captures")]
        if ex_ok["propose"] != 1 or ex_ok["verify"] != 1:
            fail(f"[mesh] (a) (e): captures {ex_ok}")
        if stats[("chunked", "captures")]["prefill_chunk"] != 1:
            fail(f"[mesh] (a) chunked: captures {stats[('chunked', 'captures')]}")
        for tag, kind, layers in (("(b)", "decode", m.n_layers), ("(e)", "verify", m.n_layers),
                                  ("(e)", "propose", SPEC_E["draft_layers"] * SPEC_E["max_k"])):
            n, per = stats[(tag, kind)]
            _check_contract(f"[mesh] (a) {tag} {kind}", n, per, layers)
            log(f"[mesh] (a) {tag}: {n} {kind} steps, per step {per}")
            out[f"{tag} {kind}"] = per
        n, per = stats[("chunked", "prefill_chunk")]
        log(f"[mesh] (a) chunked: {n} chunk steps of {MESH_CHUNK} tokens, captured once; "
            f"collectives per chunk step {per} (the cache and plan gathers over model)")
    finally:
        dist.destroy_process_group()
    out["launches"] = launches
    log(f"[mesh] (a) took {time.perf_counter() - t0:.1f} s; launches {launches}")
    return out


def mesh_gloo_rank(mesh, args):
    """One rank of phase 15 (b): the seed weights on the card, this rank's
    slots; the one-shot runs and the trace.  Returns numbers and tokens."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig
    from repro_torch.kernels import build
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 logs
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = args["cfg"].replace(executor="mesh")
    eng = Engine.build(cfg, mesh=mesh, profile=args["profile"])
    params = eng.params
    out = {"checksum": _checksum(params), "build_s": time.perf_counter() - t0}
    ref_logits = np.load(args["ref_logits"], mmap_mode="r")
    for backend in ("slot", "paged"):
        if backend == "paged":
            eng = Engine.build(cfg.replace(cache_backend="paged",
                                           paging=PagingConfig(block_size=BLOCK)),
                               mesh=mesh, params=params, profile=args["profile"])
        build.reset_launches()
        res = eng.generate(args["prompts"], GEN, teacher_tokens=args["teacher"])
        n, per = _per_step(eng.executor, "decode")
        out[backend] = {"tokens": res.tokens, "lengths": res.lengths, "steps": n,
                        "max_abs_diff": float(np.abs(res.logits - ref_logits).max()),
                        "step_ms": 1e3 * statistics.median(res.step_s),
                        "prefill_s": res.prefill_s, "per_step": per,
                        "launches": dict(build.LAUNCHES), "finite": bool(np.isfinite(res.logits).all())}
        eng.state = eng._live = None
    eng = None
    gc.collect()
    torch.cuda.empty_cache()
    ctx = {"cfg": args["cfg"], "params": params, "profile": args["profile"]}
    stats = {}

    def inspect(e, warm):
        stats["decode"] = _per_step(e.executor, "decode")
        pool = e.scheduler.backend.pool
        stats["partition_free"] = pool.free_blocks_by_partition().sum(axis=0).tolist()
        stats["partition_total"] = [pool.n_layers * (pool.part_size - 1)] * pool.n_partitions

    got, trace = continuous_run(ctx, f"mesh gloo rank {mesh.rank}", "paged", "fp32",
                                reqs=make_trace(args["cfg"].model.vocab_size)[:MESH_REQS],
                                mesh=mesh, inspect=inspect)
    out["trace"] = {k: trace[k] for k in ("tokens", "tokens_per_s", "step_ms_median", "finished",
                                          "replans", "preemptions")}
    out["trace"].update(stats, launches=got)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t0
    return out


def mesh_gloo(ctx, a):
    """Phase 15 (b): two gloo ranks sharing the card (model = 2, data = 1),
    eager, at full width."""
    import tempfile

    import numpy as np
    import torch
    from repro_torch.launch.mesh import spawn
    m = ctx["cfg"].model
    t0 = time.perf_counter()
    ref = ctx["slot_dp"]
    tmp = tempfile.mkdtemp()
    np.save(f"{tmp}/ref_logits.npy", ref.logits)
    args = {"cfg": ctx["cfg"], "profile": ctx["profile"], "prompts": ctx["prompts"],
            "teacher": ctx["teacher"], "ref_logits": f"{tmp}/ref_logits.npy"}
    parent = _checksum(ctx["params"])
    # the parent's engines are gone; only the ranks hold weights from here
    ctx["params"] = None
    gc.collect()
    torch.cuda.empty_cache()
    ranks = spawn(mesh_gloo_rank, model=2, data=1, backend="gloo", device="cuda",
                  args=(args,), init_file=f"{tmp}/rendezvous", timeout=900)
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(ref.logits).max())
    for r, out in enumerate(ranks):
        if out["checksum"] != parent:
            fail(f"[mesh] (b) rank {r}: weight checksum differs from the parent's")
        for backend in ("slot", "paged"):
            o = out[backend]
            if not np.array_equal(o["lengths"], ref.lengths):
                fail(f"[mesh] (b) rank {r} {backend}: prefill lengths differ from the local's")
            if not (o["finite"] and o["max_abs_diff"] < tol):
                fail(f"[mesh] (b) rank {r} {backend}: logit gap {o['max_abs_diff']} >= plan bar "
                     f"{tol} (or not finite)")
            _check_contract(f"[mesh] (b) rank {r} {backend}", o["steps"], o["per_step"],
                            m.n_layers)
            if not np.array_equal(o["tokens"], ranks[0][backend]["tokens"]):
                fail(f"[mesh] (b) {backend}: the ranks' tokens differ")
        t = out["trace"]
        if t["finished"] != MESH_REQS or t["tokens"] != ranks[0]["trace"]["tokens"]:
            fail(f"[mesh] (b) trace: rank {r} finished {t['finished']}, tokens equal to rank "
                 f"0's: {t['tokens'] == ranks[0]['trace']['tokens']}")
        if t["partition_free"] != t["partition_total"]:
            fail(f"[mesh] (b) trace: partitions not empty at the end: {t['partition_free']} "
                 f"free of {t['partition_total']}")
        log(f"[mesh] (b) rank {r}: weights built in {out['build_s']:.1f} s, checksum equal to "
            f"the parent's; max_memory_allocated {out['max_memory_allocated'] / 2**30:.2f} GiB; "
            + "; ".join(f"{b}: step median {out[b]['step_ms']:.2f} ms, prefill "
                        f"{out[b]['prefill_s']:.2f} s, logit gap {out[b]['max_abs_diff']:.4f} "
                        f"(bar {tol:.4f}), per step {out[b]['per_step']}"
                        for b in ("slot", "paged"))
            + f"; trace {t['finished']}/{MESH_REQS} finished, {t['tokens_per_s']:.1f} tokens/s, "
            f"tick median {t['step_ms_median']:.2f} ms, replans {t['replans']}, partitions free "
            f"{t['partition_free']}; {out['seconds']:.1f} s")
    same = sum(x == y for x, y in zip(ranks[0]["trace"]["tokens"], a["trace_tokens"]))
    tok = [ranks[0][b]["tokens"] for b in ("slot", "paged")]
    log(f"[mesh] (b) prefill lengths bitwise the local executor's on both ranks and backends; "
        f"the ranks' tokens identical; one-shot argmax equal to the local run at "
        + ", ".join(f"{100 * float((t_ == ref.tokens).mean()):.1f}%" for t_ in tok)
        + f" of positions (slot, paged); trace: {same}/{MESH_REQS} requests with the local "
        f"(a) (b) run's tokens (bf16 summation order differs; reported, not a bar)")
    launches = {}
    for out in ranks[:1]:  # rank 0's launches (each rank launches its own kernels)
        for part in (out["slot"]["launches"], out["paged"]["launches"], out["trace"]["launches"]):
            for k, v in part.items():
                launches[k] = launches.get(k, 0) + v
    log(f"[mesh] (b) took {time.perf_counter() - t0:.1f} s; rank 0 launches {launches}")
    return {"launches": launches}


def mesh_runs(ctx):
    """Phase 15: (a) one NCCL rank, graphed; (b) two gloo ranks sharing the
    card.  Prints the phase's time and launches."""
    t0 = time.perf_counter()
    a = mesh_nccl(ctx)
    b = mesh_gloo(ctx, a)
    log(f"[mesh] phase 15 took {time.perf_counter() - t0:.1f} s; launches (a) {a['launches']}, "
        f"(b) rank 0 {b['launches']}")
    log("[mesh] summary " + json.dumps({k: v for k, v in a.items()
                                        if k not in ("trace_tokens", "launches")}))


# ---------------------------------------------------------------------------
# phase 16: the other configs the port serves
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ("gemma2-9b", "granite-3-2b", "qwen1.5-110b", "granite-moe-1b-a400m",
                "qwen3-moe-30b-a3b")
DENSE_FAMILY = ("gemma2-9b", "granite-3-2b", "qwen1.5-110b")
GEMMA_B, GEMMA_T = 4, 4608  # T past gemma2's 4096-token window, so it binds
# the first requests of phase 7's trace: phase 16's traces were cut from 8
# to 4 requests to make room for phase 17 within the 1200 s limit; phase 17
# runs 8
FAMILY_REQS, FAMILY_CHUNK_REQS, P17_REQS = 4, 4, 8
# configurations at full width cut in depth (published depth in the model's
# config): qwen1.5-110b to 4 of 80 layers (~7.9 B parameters, 15.9 GB in
# bf16), qwen3-moe-30b-a3b to 8 of 48 (~5.6 B); phase 17's llava-next-34b
# to 12 of 60 (~7.6 B: at full depth its ~34.4 B parameters, ~69 GB in
# bf16, leave no room on one 80 GB card for its slot weights and cache);
# since the script took 1160-1257 s with phase 24 on an NVIDIA H100 80GB
# HBM3, 700.00 W: mamba2-1.3b to 12 of 48 (no plan: its one-shot's bars do
# not scale with the depth), gemma2-9b to 10 of 42 and granite-3-2b to 10
# of 40 (their plan gaps were 0.124 and 0.0781 against bars of 2.4326 and
# 0.7422 at full depth; the bar scales with the layers)
FAMILY_CUTS = {"qwen1.5-110b": 4, "qwen3-moe-30b-a3b": 8, "llava-next-34b": 12,
               "mamba2-1.3b": 12, "gemma2-9b": 10, "granite-3-2b": 10}


def _smoke_batch(model, seed=SEED):
    """Two 40-token prompts (numpy), plus the stub frontends' inputs the
    model takes: a VLM's image embeddings, an encoder-decoder's frames."""
    import numpy as np
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, 256, size=(2, 40)).astype(np.int32)}
    if model.is_vlm:
        batch["image_embeds"] = (0.02 * rng.standard_normal(
            (2, model.num_image_tokens, model.d_model))).astype(np.float32)
    if model.is_encoder_decoder:
        batch["frames"] = (0.02 * rng.standard_normal(
            (2, model.encoder_seq_len, model.d_model))).astype(np.float32)
    return batch


def family_smoke_parity(cases=None, tag="[family]"):
    """Phase 16 (a), and phase 17's: each config's smoke variant on the card
    against the port's CPU path (same weights, fp32): one-shot fairkv_dp and
    the continuous scheduler on paged pools in the engine dtype; the dense
    configs also speculative (a 1-layer draft) and chunked (8-token
    chunks).  Identical tokens and lengths, logits within 1e-3 (phase 4's
    bar: fp32 summed in another order).  ``cases`` are (arch, ModelConfig
    overrides, run names) (default: phase 16's configs).  Returns the
    launches of the card runs."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch import interop
    from repro_torch.api import (CompressionConfig, Engine, EngineConfig, PagingConfig,
                                 PlannerConfig, PrefixConfig, SchedulerConfig,
                                 SpeculationConfig, synthesize_requests)
    launches = {}
    extras = {"oneshot": {}, "continuous": {},
              "speculative": {"speculation": SpeculationConfig(enabled=True, max_k=3,
                                                               draft_layers=1)},
              "chunked": {"prefix": PrefixConfig(chunk_tokens=8)}}
    if cases is None:
        cases = [(arch, {}, ("oneshot", "continuous")
                  + (("speculative", "chunked") if arch in DENSE_FAMILY else ()))
                 for arch in FAMILY_ARCHS]
    for arch, over, names in cases:
        todo = [(name, extras[name]) for name in names]
        label = arch + "".join(f" {k}={v}" for k, v in over.items())
        params = {}
        for name, extra in todo:
            out = {}
            for dev in ("cpu", "cuda"):
                cfg = EngineConfig.smoke(
                    arch, n_shards=4, max_seq_len=64, device=dev,
                    compression=CompressionConfig(policy="ada_snapkv", budget=12,
                                                  alpha_max=2.0, obs_window=8, sink=2,
                                                  decode_margin=8),
                    planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=2),
                    scheduler=SchedulerConfig(max_rows=2, collect_logits=True),
                    cache_backend="slot" if name == "oneshot" else "paged",
                    paging=PagingConfig(block_size=8), **extra)
                if over:
                    cfg = cfg.replace(model=dataclasses.replace(cfg.model, **over))
                toks = _smoke_batch(cfg.model)
                if dev not in params:
                    params[dev] = (Engine.build(cfg).params if dev == "cpu" else
                                   interop.to_torch(interop.to_numpy(params["cpu"]), "cuda"))
                eng = Engine.build(cfg, params=params[dev])
                if name == "oneshot":
                    res, got = _count(lambda: eng.generate(toks, 6))
                    out[dev] = (res.tokens, res.lengths, res.logits)
                else:
                    reqs = synthesize_requests(4, 0.5, cfg.model.vocab_size, min_prompt=12,
                                               max_prompt=24, max_new_tokens=6, seed=0)
                    summ, got = _count(lambda: eng.run_trace(reqs, max_steps=500))
                    pool = eng.scheduler.backend.pool  # None without attention
                    if summ["finished"] != 4 or (pool is not None and pool.blocks_in_use()):
                        fail(f"{tag} (a) {label} {name} on {dev}: {summ['finished']}/4 "
                             f"finished or blocks left in the pool")
                    out[dev] = ([r.generated for r in reqs], None,
                                [np.stack(r.logits) for r in reqs])
                if dev == "cuda":
                    for k, v in got.items():
                        launches[k] = launches.get(k, 0) + v
            (ta, la, ga), (tb, lb, gb) = out["cpu"], out["cuda"]
            gap = (float(np.abs(ga - gb).max()) if name == "oneshot" else
                   max(float(np.abs(x - y).max()) for x, y in zip(ga, gb)))
            same_len = la is None or np.array_equal(la, lb)
            same_tok = np.array_equal(ta, tb) if name == "oneshot" else ta == tb
            if not (same_tok and same_len and gap < 1e-3):
                fail(f"{tag} (a) {label} {name}: card vs CPU tokens equal {same_tok}, "
                     f"lengths equal {same_len}, max |dlogits| {gap:.3e} (bar 1e-3)")
            log(f"{tag} (a) {label} smoke {name}: card == CPU tokens"
                + (" and lengths" if la is not None else "") + f"; max |dlogits| {gap:.3e}")
        del params
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def family_config(arch, b, t, mode="sha", ch=0):
    """A full-width config on the card in bf16 with phase 5's compression
    and slot grid (8 shards x 2 slots); ``FAMILY_CUTS`` cuts the depth."""
    from repro_torch.api import CompressionConfig, EngineConfig, PlannerConfig
    # max_seq_len sizes an encoder-decoder's learned positions: the prompt,
    # the generated tokens and `_step_times`' further steps
    cfg = EngineConfig.for_arch(
        arch, n_shards=N_SHARDS, dtype="bfloat16", max_seq_len=t + 2 * GEN, seed=SEED,
        device="cuda",
        compression=CompressionConfig(policy="ada_snapkv", budget=BUDGET, alpha_max=ALPHA,
                                      obs_window=OBS, pool=POOL, sink=SINK,
                                      decode_margin=MARGIN),
        planner=PlannerConfig(mode=mode, extra_copies=ch, slots_per_shard=SLOTS_PER_SHARD,
                              batch_cap=b))
    if arch in FAMILY_CUTS:
        cfg = cfg.replace(model=cfg.model.with_overrides(n_layers=FAMILY_CUTS[arch]))
    return cfg


def _n_params(params) -> int:
    n = 0
    for v in params.values():
        if isinstance(v, dict):
            n += _n_params(v)
        elif isinstance(v, list):
            n += sum(_n_params(x) for x in v)
        else:
            n += v.numel()
    return n


def family_oneshot(arch, b, t, modes=(("sha", 0), ("fairkv_dp", 4)), bias=False):
    """One-shot `generate` of a full-width config under each planner (the
    later ones teacher-forced on the first's tokens), with the launch
    counters per run; bars: kernel 1 n_layers x GEN and kernel 2 n_layers
    launches per run, lengths bitwise plan-invariant, the logit gap under
    n_layers 2^-8 max|logit| (dense; for MoE reported: a plan's rounding
    can flip a near-tied expert pick), finite logits of the expected shape; then an
    eager engine (no CUDA graph) teacher-forced alike: tokens equal to the
    graphed run's (and for MoE its logits bitwise).  ``bias`` draws the
    qkv biases non-zero (the init's are zeros).  Returns a ctx for
    `continuous_run` and the record printed."""
    import numpy as np
    import torch
    from repro_torch.api import Engine
    from repro_torch.configs.base import InputShape
    from repro_torch.training.data import SyntheticLM
    t0 = time.perf_counter()
    cfg = family_config(arch, b, t, *modes[0])
    m = cfg.model
    data = SyntheticLM(m, InputShape("chip_smoke", t, b, "prefill"))
    prompts = data.get_batch(0)  # tokens, and the stub frontends' inputs
    n_attn = 0 if m.attention_free else m.n_layers  # layers that launch kernels
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = Engine.build(cfg)
    params = probe.params
    if bias:
        g = torch.Generator(device="cuda")
        g.manual_seed(SEED + 5)
        for pl in params["layers"]:
            for key in ("bq", "bk", "bv"):
                pl[key].copy_(torch.randn(pl[key].shape, generator=g, device="cuda") * 0.5)
    profile = probe.measure_profile(data.get_batch(123))
    del probe
    rec = {"arch": m.name, "layers": m.n_layers, "cut": arch in FAMILY_CUTS,
           "params": _n_params(params), "runs": {}}
    results, eng = {}, None
    for mode, ch in modes:
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(cfg.replace(planner=family_config(arch, b, t, mode, ch).planner),
                           params=params, profile=profile)
        teacher = None if not results else results[modes[0][0]].tokens[:, :GEN]
        res, got = _count(lambda: eng.generate(prompts, GEN, teacher_tokens=teacher))
        if got["fairkv_decode"] != n_attn * GEN or got["snapkv_scores"] != n_attn:
            fail(f"[family] {arch} {mode}: launches {got}, expected fairkv_decode "
                 f"{n_attn} x {GEN}, snapkv_scores {n_attn}")
        if res.logits.shape != (b, GEN + 1, m.padded_vocab) or not np.isfinite(res.logits).all():
            fail(f"[family] {arch} {mode}: logits {res.logits.shape} or not finite")
        results[mode] = res
        dev_ms, k1_ms = _step_times(eng)
        rec["runs"][mode] = {"prefill_s": res.prefill_s,
                             "step_ms_host": 1e3 * statistics.median(res.step_s),
                             "step_ms_device": dev_ms, "kernel1_ms_per_step": k1_ms,
                             "efficiency": res.efficiency, "launches": got}
        if not m.attention_free:  # Eq. 4: the plan's per-shard load, realized
            load = eng.plan.per_shard_load(res.realized_profile)
            rec["runs"][mode]["shard_load_max_over_mean"] = float(load.max() / load.mean())
    base = results[modes[0][0]]
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(base.logits).max())
    for mode, _ in modes[1:]:
        r = results[mode]
        gap = float(np.abs(r.logits - base.logits).max())
        if not np.array_equal(r.lengths, base.lengths):
            fail(f"[family] {arch}: lengths under {mode} differ from {modes[0][0]}'s")
        # MoE: a plan changes the o-projection's bf16 rounding, which can flip
        # a near-tied top-k expert pick, a discrete change the smooth bound
        # does not cover; its gap is reported (the CPU tests bar MoE's plan
        # invariance in fp32, and eager == graphed is bitwise below)
        if not gap < tol and not m.moe.num_experts:
            fail(f"[family] {arch}: logit gap {mode} vs {modes[0][0]} {gap} >= {tol}")
        rec["runs"][mode].update(logit_gap=gap, argmax_agree=float(
            (r.logits.argmax(-1) == base.logits.argmax(-1)).mean()))
    rec["logit_bar"] = tol
    # graphed against eager, the last plan, teacher-forced alike
    last_mode = modes[-1][0]
    graphed = results[last_mode]
    eng.executor = eager_executor(eng.cfg)
    teacher = None if len(modes) == 1 else base.tokens[:, :GEN]
    eager = eng.generate(prompts, GEN, teacher_tokens=teacher)
    same = bool(np.array_equal(eager.tokens, graphed.tokens))
    bitwise = bool(np.array_equal(eager.logits, graphed.logits))
    if not same or (m.moe.num_experts and not bitwise):
        fail(f"[family] {arch}: eager vs graphed tokens equal {same}, logits bitwise {bitwise}")
    rec.update(graphed_equals_eager_tokens=same, graphed_equals_eager_logits=bitwise,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t0)
    # phase 22 (a) runs this one-shot through the cell step: the eager run's
    # result and final state (on the host) are its reference
    ctx = {"cfg": cfg.replace(planner=family_config(arch, b, t, *modes[-1]).planner),
           "params": params, "profile": profile, "prompts": prompts,
           "cache": eng.state.cache, "results": results, "eager": eager,
           "state": _p22_states(eng.state), "teacher": base.tokens[:, :GEN]}
    del eng
    log(f"[family] {m.name} ({m.n_layers} layers{', cut in depth' if rec['cut'] else ''}, "
        f"{rec['params'] / 1e9:.2f} B parameters, B={b}, T={t}): "
        + "; ".join(f"{mode}: prefill {r['prefill_s']:.2f} s, step {r['step_ms_host']:.2f} ms "
                    f"host / {r['step_ms_device']:.2f} ms device (kernel 1 "
                    f"{r['kernel1_ms_per_step']:.3f} ms), E={r['efficiency']}, per-shard load "
                    f"max/mean {r.get('shard_load_max_over_mean')}, launches "
                    f"{r['launches']}" for mode, r in rec["runs"].items())
        + f"; lengths plan-invariant, logit gaps "
        f"{[round(r.get('logit_gap', 0.0), 4) for r in rec['runs'].values()]} "
        f"({'reported, not a bar: expert routing' if m.moe.num_experts else 'bar'} {tol:.4f}), "
        f"argmax agreement {[r.get('argmax_agree') for r in rec['runs'].values()][1:]}; "
        f"eager == graphed tokens {same}, logits bitwise {bitwise}; max_memory_allocated "
        f"{rec['max_memory_allocated'] / 2**30:.2f} GiB; {rec['seconds']:.1f} s")
    return ctx, rec


def sdpa_decode_ms(q, k, v, ln, flush, k_pos=None, q_pos=None, window=0):
    """The efficient SDPA (``F.scaled_dot_product_attention``) on kernel 1's
    inputs (q (B, S, G, Dh), k / v (S, B, C, Dh), lengths (S, B)), each
    (slot, row) pair a batch entry with its G query heads over its one K / V
    head, the lengths (and a window's positions) as a boolean mask: its
    device ms, the same 25-call median after an L2 flush as the kernel's
    (a softcap, which SDPA has not, is left out: the library's time of the
    same attention without it)."""
    import torch
    import torch.nn.functional as F
    S, Bq, C, Dh = k.shape
    G = q.shape[2]
    qs = q.permute(1, 0, 2, 3).reshape(S * Bq, G, 1, Dh)
    ks = k.reshape(S * Bq, 1, C, Dh)
    vs = v.reshape(S * Bq, 1, C, Dh)
    keep = torch.arange(C, device="cuda")[None, :] < ln.reshape(-1, 1)
    if window:
        qp = q_pos[None, :].expand(S, Bq).reshape(-1, 1)
        keep = keep & (k_pos.reshape(S * Bq, C) > qp - window)
    mask = keep[:, None, None, :]
    return time_ms(lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask,
                                                          enable_gqa=True), flush)


def time_gemma_kernels(ctx, rows):
    """Phase 10's table at gemma2-9b's main-path shapes (``*_gemma2`` keys):
    kernels 1 and 3 on its one-shot's own cache (layer 1, a global layer;
    layer 0, a window layer: ``*_gemma2_window``), kernel 4 on that cache
    at Q = 5 (head_dim 256), kernel 2 at its prefill shape (B 4, W 32,
    Hq 16, Hkv 8, Dh 256, T 4608)."""
    time_config_kernels(ctx, rows, "gemma2-9b", ((1, "_gemma2"), (0, "_gemma2_window")),
                        GEMMA_B, GEMMA_T, mq_sfx="_gemma2")


def time_config_kernels(ctx, rows, label, layers, b, t, mq_sfx=None):
    """A config's kernel times on its one-shot's own cache (``ctx["cache"]``,
    after decode), added to the rows as keys with each layer's suffix:
    kernel 1 on each of ``layers`` ((layer, suffix) pairs, with the layer's
    window and the model's softcap), kernel 3 on that cache laid out as
    bf16 pools (identity block table), with ``mq_sfx`` kernel 4 on it at
    Q = 5 (the last window of each row at its length), and kernel 2 at the
    prefill shape (B = ``b``, W 32, T = ``t``); each beside its plain
    version and the bound (the bytes read once at 3.35 TB/s, or the
    operations at 989 TFLOP/s when larger)."""
    import torch
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda
    from repro_torch.kernels.paged_fairkv_decode import (paged_fairkv_decode_cuda,
                                                         paged_fairkv_decode_mq_cuda)
    from repro_torch.kernels.ref import (fairkv_decode_ref, paged_fairkv_decode_ref,
                                         snapkv_scores_ref)
    from repro_torch.kernels.snapkv_select import snapkv_scores_cuda
    from repro_torch.paging.testing import slot_layer_as_pool
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 7)
    m = ctx["cfg"].model
    cache = ctx.pop("cache")  # the one-shot's cache after decode
    by_name = {r["name"]: r for r in rows}
    for li, (layer, sfx) in enumerate(layers):
        k, v, ln, kp = cache.k[layer], cache.v[layer], cache.lengths[layer], cache.pos[layer]
        S, Bq, C, Dh = k.shape
        G = m.q_per_kv
        window = m.sliding_window if m.layer_is_local(layer) else 0
        q = torch.randn((Bq, S, G, Dh), generator=gen, device="cuda").to(k.dtype)
        qp = torch.full((Bq,), t + GEN, dtype=torch.int32, device="cuda")
        kw = dict(attn_cap=m.attn_softcap, k_pos=kp, q_pos=qp, window=window)
        err = _cmp(f"fairkv_decode ({label} layer {layer})", fairkv_decode_cuda(q, k, v, ln, **kw),
                   fairkv_decode_ref(q, k, v, ln, **kw), FP32_TOL, BF16_ULP)
        kern = time_ms(lambda: fairkv_decode_cuda(q, k, v, ln, **kw), flush)
        plain = time_ms(lambda: fairkv_decode_ref(q, k, v, ln, **kw), flush)
        lib = sdpa_decode_ms(q, k, v, ln, flush, kp, qp, window)
        n_ret = int(ln.sum().item())
        it = k.element_size()
        nbytes = n_ret * Dh * 2 * it + 2 * q.numel() * it + ln.numel() * 4 + (
            n_ret * 4 if window else 0)
        bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, 4 * n_ret * G * Dh / BF16_FLOP_PER_S)
        kpool, vpool, ppool, tbl = slot_layer_as_pool(k, v, kp, BLOCK)
        pargs = (q, kpool, vpool, ppool, tbl, ln, C)
        pkw = dict(attn_cap=m.attn_softcap, q_pos=qp, window=window)
        pout = paged_fairkv_decode_cuda(*pargs, **pkw)
        perr = _cmp_paged(f"paged_fairkv_decode ({label} layer {layer})", pout,
                          paged_fairkv_decode_ref(*pargs, **pkw))
        if not torch.equal(pout, fairkv_decode_cuda(q, k, v, ln, **kw)):
            fail(f"{label} layer {layer}: kernel 3 over the cache as pools is not bitwise "
                 f"kernel 1's")
        pkern = time_ms(lambda: paged_fairkv_decode_cuda(*pargs, **pkw), flush)
        pplain = time_ms(lambda: paged_fairkv_decode_ref(*pargs, **pkw), flush)
        n_blk = int(((ln + BLOCK - 1) // BLOCK).sum().item())
        pbound = 1e3 * max((nbytes + n_blk * 4) / HBM_BYTES_PER_S,
                           4 * n_ret * G * Dh / BF16_FLOP_PER_S)
        by_name["fairkv_decode"].update({f"ms{sfx}": kern, f"plain_ms{sfx}": plain,
                                         f"bound_ms{sfx}": bound, f"max_abs_err{sfx}": err,
                                         f"library_ms{sfx}": lib})
        by_name["paged_fairkv_decode"].update({f"ms{sfx}": pkern, f"plain_ms{sfx}": pplain,
                                               f"bound_ms{sfx}": pbound,
                                               f"max_abs_err{sfx}": perr})
        log(f"[time] {label} layer {layer} ({'window ' + str(window) if window else 'global'}, "
            f"softcap {m.attn_softcap}) at (B={Bq}, S={S}, G={G}, C={C}, Dh={Dh}) bf16, "
            f"sum(lengths)={n_ret}: fairkv_decode {kern:.4f} ms (plain {plain:.4f}, SDPA "
            f"{lib:.4f} (no softcap), bound {bound:.4f} ms = {nbytes} B / 3.35 TB/s); "
            f"paged_fairkv_decode over the cache as "
            f"pools {pkern:.4f} ms (plain {pplain:.4f}, bound {pbound:.4f} ms), bitwise "
            f"kernel 1's")
        if mq_sfx is not None and li == 0:
            Q = 5  # a verify window of max_k 4 + 1, every row's full, at its length
            q4 = torch.randn((Bq, S, Q, G, Dh), generator=gen, device="cuda").to(k.dtype)
            ql = torch.full((Bq,), Q, dtype=torch.int32, device="cuda")
            margs = (q4,) + pargs[1:]
            mkw = dict(pkw, q_lens=ql)
            merr = _cmp(f"paged_fairkv_decode_mq ({label} layer {layer}, Q={Q})",
                        paged_fairkv_decode_mq_cuda(*margs, **mkw),
                        paged_fairkv_decode_ref(*margs, **mkw), FP32_TOL, BF16_ULP)
            mkern = time_ms(lambda: paged_fairkv_decode_mq_cuda(*margs, **mkw), flush)
            mplain = time_ms(lambda: paged_fairkv_decode_ref(*margs, **mkw), flush)
            lnT = ln.T.long()[:, :, None]
            vis = torch.clamp(torch.minimum(lnT - (Q - 1 - torch.arange(Q, device="cuda")),
                                            lnT), min=0)
            n_vis = int(vis.sum().item())
            mbytes = (n_ret * Dh * 2 * it + n_blk * 4 + 2 * q4.numel() * it + ln.numel() * 4
                      + Bq * 4 + (n_ret * 4 if window else 0))
            mbound = 1e3 * max(mbytes / HBM_BYTES_PER_S, 4 * n_vis * G * Dh / BF16_FLOP_PER_S)
            by_name["paged_fairkv_decode_mq"].update({
                f"ms{mq_sfx}": mkern, f"plain_ms{mq_sfx}": mplain, f"bound_ms{mq_sfx}": mbound,
                f"max_abs_err{mq_sfx}": merr})
            log(f"[time] {label} layer {layer} paged_fairkv_decode_mq at (B={Bq}, S={S}, Q={Q}, "
                f"G={G}, Dh={Dh}, bs={BLOCK}) bf16 on the cache as pools, {n_vis} visible "
                f"(query, column) pairs: kernel {mkern:.4f} ms, plain {mplain:.4f} ms, bound "
                f"{mbound:.4f} ms ({mbytes} B / 3.35 TB/s)")
    q2 = torch.randn((b, OBS, m.n_heads, m.head_dim), generator=gen,
                     device="cuda").to(torch.bfloat16)
    k2 = torch.randn((b, t, m.n_kv_heads, m.head_dim), generator=gen,
                     device="cuda").to(torch.bfloat16)
    kpos = torch.arange(t, dtype=torch.int32, device="cuda").expand(b, t).contiguous()
    opos = kpos[:, t - OBS:].contiguous()
    skw = dict(attn_cap=m.attn_softcap)
    err2 = _cmp(f"snapkv_scores ({label} prefill shape)",
                snapkv_scores_cuda(q2, k2, opos, kpos, **skw),
                snapkv_scores_ref(q2, k2, opos, kpos, **skw), FP32_TOL, 1e-5)
    kern2 = time_ms(lambda: snapkv_scores_cuda(q2, k2, opos, kpos, **skw), flush)
    plain2 = time_ms(lambda: snapkv_scores_ref(q2, k2, opos, kpos, **skw), flush)
    nbytes2, flops2, bound2 = _scores_bound(q2, k2, opos, kpos)
    sfx2 = layers[0][1]
    by_name["snapkv_scores"].update({f"ms{sfx2}": kern2, f"plain_ms{sfx2}": plain2,
                                     f"bound_ms{sfx2}": bound2, f"max_abs_err{sfx2}": err2})
    log(f"[time] {label} snapkv_scores at (B={b}, W={OBS}, Hq={m.n_heads}, "
        f"Hkv={m.n_kv_heads}, Dh={m.head_dim}, T={t}) bf16, softcap {m.attn_softcap}: "
        f"kernel {kern2:.4f} ms, plain {plain2:.4f} ms, bound {bound2:.4f} ms (max of "
        f"{nbytes2} B / 3.35 TB/s and {flops2} FLOP / 989 TFLOP/s)")


def _family_trace(ctx, name, n, **kw):
    """`continuous_run` on bf16 pools over the first ``n`` requests of
    phase 7's trace (with ``chunk``: the first ``n`` whose prompts are
    longer than one chunk)."""
    reqs = make_trace(ctx["cfg"].model.vocab_size)
    if kw.get("changes", {}).get("prefix") is not None:
        reqs = [r for r in reqs if r.prompt_len > kw["changes"]["prefix"].chunk_tokens]
    return continuous_run(ctx, name, "paged", "fp32", reqs=reqs[:n], **kw)


def _bias_replan(ctx):
    """qwen1.5-110b (cut): 4 requests of phase 7's trace through the
    scheduler with a replan between ticks (from the realized profile, or,
    if that one does not lower the imbalance, against a straggler shard at
    half speed): after the accepted replan every live slot holds its
    head's biases under the new plan, bitwise, and every request
    finishes."""
    import numpy as np
    import torch
    from repro_torch.api import Engine, PagingConfig, SchedulerConfig
    cfg = ctx["cfg"].replace(cache_backend="paged",
                             scheduler=SchedulerConfig(max_rows=MAX_ROWS, enable_replan=False),
                             paging=PagingConfig(block_size=BLOCK))
    eng = Engine.build(cfg, params=ctx["params"], profile=ctx["profile"])
    reqs = make_trace(cfg.model.vocab_size)[:4]
    for r in reqs:
        r.arrival_step = 0
        eng.submit(r)
    for _ in range(3):
        eng.step()
    if not eng.scheduler.active:
        fail("[family] qwen1.5 replan: no request live after 3 ticks")
    before = eng.pa.slot_head.clone()
    ev = eng.replan()
    if not ev["accepted"]:  # a straggler: shard 0 at half speed
        ev = eng.replan(shard_speeds=[0.5] + [1.0] * (cfg.n_shards - 1))
    if not ev["accepted"] or torch.equal(before, eng.pa.slot_head):
        fail(f"[family] qwen1.5 replan: no replan accepted ({ev})")
    for i, pl in enumerate(eng.sp["layers"]):
        sh = eng.pa.slot_head[i].long()
        live = sh >= 0
        orig = eng.params["layers"][i]
        bq = orig["bq"].reshape(cfg.model.n_kv_heads, cfg.model.q_per_kv, -1)
        if not (torch.equal(pl["bq_s"][live], bq[sh[live]])
                and torch.equal(pl["bk_s"][live], orig["bk"][sh[live]])
                and torch.equal(pl["bv_s"][live], orig["bv"][sh[live]])):
            fail(f"[family] qwen1.5 replan: layer {i}'s slot biases are not the new plan's")
    n = 0
    while any(not r.is_finished for r in reqs) and n < 2000:
        eng.step()
        n += 1
    if any(not r.is_finished for r in reqs) or eng.scheduler.backend.pool.blocks_in_use():
        fail("[family] qwen1.5 replan: requests unfinished or blocks left after the replan")
    log(f"[family] qwen1.5-110b (cut): replan accepted after 3 ticks (shard speeds "
        f"{ev.get('shard_speeds')}, imbalance "
        f"{ev['imbalance_before']:.4f} -> {ev['imbalance_after']:.4f}); every live slot's "
        f"q/k/v biases bitwise its head's under the new plan; 4/4 requests finished, pool empty")


def family_runs(rows):
    """Phase 16: (a) the smoke variants against the CPU path; (b)
    gemma2-9b at full width and depth; (c) granite-3-2b and (d)
    granite-moe-1b-a400m at full width and depth; (e) qwen1.5-110b and
    qwen3-moe-30b-a3b at full width, cut in depth.  Prints each config's
    record and the phase's time and launches (apart from the kernel
    table), and adds gemma2's kernel timings to ``rows``."""
    import torch
    from repro_torch.api import PrefixConfig, SpeculationConfig
    t0 = time.perf_counter()
    launches = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    add(family_smoke_parity())
    records, p21_moe = {}, None
    # (b) gemma2-9b, full width and depth
    ctx, rec = family_oneshot("gemma2-9b", GEMMA_B, GEMMA_T)
    add({k: v for r in rec["runs"].values() for k, v in r["launches"].items()})
    time_gemma_kernels(ctx, rows)
    for name, kw in (("gemma2 trace", {}),
                     ("gemma2 spec", {"spec": SpeculationConfig(**SPEC_GEMMA)}),
                     ("gemma2 chunk", {"changes": {"prefix": PrefixConfig(chunk_tokens=CHUNK)}})):
        n = FAMILY_CHUNK_REQS if "changes" in kw else FAMILY_REQS
        got, out = _family_trace(ctx, name, n, **kw)
        add(got)
        rec[name] = {k: out[k] for k in ("finished", "decode_ticks", "step_ms_median",
                                         "tokens_per_s", "acceptance", "chunks")}
    records["gemma2-9b"] = rec
    ctx = None
    gc.collect()
    torch.cuda.empty_cache()
    # (c) granite-3-2b and (d) granite-moe-1b-a400m, full width and depth
    for arch in ("granite-3-2b", "granite-moe-1b-a400m"):
        ctx, rec = family_oneshot(arch, B, T)
        ctx.pop("cache")
        add({k: v for r in rec["runs"].values() for k, v in r["launches"].items()})
        got, out = _family_trace(ctx, f"{arch} trace", FAMILY_REQS)
        add(got)
        rec["trace"] = {k: out[k] for k in ("finished", "decode_ticks", "step_ms_median",
                                            "tokens_per_s")}
        if ctx["cfg"].model.moe.num_experts:
            # phase 21 (b) runs this one-shot through the cell step
            res = ctx["results"]
            p21_moe = {"cfg": ctx["cfg"], "profile": ctx["profile"],
                       "prompts": ctx["prompts"]["tokens"], "slot_dp": res["fairkv_dp"],
                       "teacher": res["sha"].tokens[:, :GEN],
                       "plan_gap": rec["runs"]["fairkv_dp"]["logit_gap"],
                       "plan_argmax": rec["runs"]["fairkv_dp"]["argmax_agree"]}
            try:
                ctx["cfg"].replace(cache_backend="paged",
                                   speculation=SpeculationConfig(**SPEC_E))
            except ValueError as e:
                if "speculative decoding supports dense attention families only" not in str(e):
                    raise
                log(f"[family] {arch}: a speculative engine is refused: {e}")
            else:
                fail(f"[family] {arch}: a speculative config was accepted")
        records[arch] = rec
        ctx = None
        gc.collect()
        torch.cuda.empty_cache()
    # (e) full width, cut in depth
    ctx, rec = family_oneshot("qwen1.5-110b", B, T, bias=True)
    ctx.pop("cache")
    add({k: v for r in rec["runs"].values() for k, v in r["launches"].items()})
    _bias_replan(ctx)
    records["qwen1.5-110b"] = rec
    ctx = None
    gc.collect()
    torch.cuda.empty_cache()
    ctx, rec = family_oneshot("qwen3-moe-30b-a3b", B, T)
    add({k: v for r in rec["runs"].values() for k, v in r["launches"].items()})
    records["qwen3-moe-30b-a3b"] = rec
    ctx = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[family] phase 16 took {time.perf_counter() - t0:.1f} s; launches {launches}")
    log("[family] summary " + json.dumps(records))
    return p21_moe


# ---------------------------------------------------------------------------
# phase 17: the SSM, hybrid, encoder-decoder and VLM families
# ---------------------------------------------------------------------------

# (a)'s smoke variants: (arch, ModelConfig overrides, runs); hymba at G = 5
# and llava at G = 7 reach the decode kernels' masked-head instantiations
P17_SMOKE = [("mamba2-1.3b", {}, ("oneshot", "continuous")),
             ("hymba-1.5b", {}, ("oneshot", "continuous")),
             ("hymba-1.5b", {"n_kv_heads": 1}, ("oneshot", "continuous")),
             ("whisper-small", {}, ("oneshot",)),
             ("llava-next-34b", {}, ("oneshot",)),
             ("llava-next-34b", {"n_heads": 14, "n_kv_heads": 2}, ("oneshot",))]
WHISPER_PROMPT = 256  # decoder prompt tokens (its context is 448 positions)
LLAVA_B, LLAVA_TEXT = 2, 1024  # rows, text tokens after the 2880 image tokens


def p17_runs(rows):
    """Phase 17: (a) the smoke variants against the CPU path; (b)
    hymba-1.5b at full width and depth (one-shot 8 x 2048 under sha and
    fairkv_dp, kernels 1-3 on its cache, 8 requests of phase 7's trace on
    bf16 pools); (c) mamba2-1.3b at full width and depth (one-shot 8 x
    2048, no kernel launched; 8 requests on the slot backend, imbalance
    1.0); (d) whisper-small at full width and depth (8 x 1500 stub frames,
    a 256-token decoder prompt); (e) llava-next-34b at full width, cut to
    12 of 60 layers (2 x (2880 image + 1024 text tokens)), kernels 1-3 at
    its shapes.  Prints each config's record and the phase's time and
    launches (apart from the kernel table); adds the ``*_hymba`` and
    ``*_llava`` keys to ``rows``.  Returns each arch's one-shot for phase
    22 (a) (`_p22_ref`)."""
    import torch
    t0 = time.perf_counter()
    launches = {}
    p22 = {}

    def add(got):
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v

    def oneshot_launches(rec):
        add({k: v for r in rec["runs"].values() for k, v in r["launches"].items()})

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    add(family_smoke_parity(P17_SMOKE, tag="[p17]"))
    records = {}
    # (b) hymba-1.5b: 5 kv heads over 8 shards, G = 5, window 1024 < T
    ctx, rec = family_oneshot("hymba-1.5b", B, T)
    oneshot_launches(rec)
    time_config_kernels(ctx, rows, "hymba-1.5b", ((0, "_hymba"),), B, T)
    got, out = _family_trace(ctx, "hymba trace", P17_REQS)
    add(got)
    rec["trace"] = {k: out[k] for k in ("finished", "decode_ticks", "step_ms_median",
                                        "tokens_per_s", "replans_accepted")}
    records["hymba-1.5b"] = rec
    p22["hymba-1.5b"] = _p22_ref(ctx)
    ctx = None
    free()
    # (c) mamba2-1.3b: attention-free, a trivial plan, no kernel
    ctx, rec = family_oneshot("mamba2-1.3b", B, T, modes=(("sha", 0),))
    oneshot_launches(rec)
    if any(rec["runs"]["sha"]["launches"].values()):
        fail(f"[p17] mamba2-1.3b launched kernels: {rec['runs']['sha']['launches']}")
    imb = {}
    got, out = continuous_run(
        ctx, "mamba2 trace", "slot", "fp32", reqs=make_trace(ctx["cfg"].model.vocab_size)[
            :P17_REQS], inspect=lambda eng, _: imb.update(v=eng.imbalance()))
    add(got)
    if imb["v"] != 1.0 or any(got.values()):
        fail(f"[p17] mamba2 trace: imbalance {imb['v']} (must be 1.0), launches {got}")
    rec["trace"] = {k: out[k] for k in ("finished", "decode_ticks", "step_ms_median",
                                        "tokens_per_s")}
    rec["trace"]["imbalance"] = imb["v"]
    records["mamba2-1.3b"] = rec
    p22["mamba2-1.3b"] = _p22_ref(ctx)
    ctx = None
    free()
    # (d) whisper-small: 12 encoder + 12 decoder layers over 1500 frames
    ctx, rec = family_oneshot("whisper-small", B, WHISPER_PROMPT)
    ctx.pop("cache")
    oneshot_launches(rec)
    records["whisper-small"] = rec
    p22["whisper-small"] = _p22_ref(ctx)
    ctx = None
    free()
    # (e) llava-next-34b, cut to 12 of 60 layers: G = 7, 3904-token prompts
    from repro_torch.configs import get_config
    t_llava = get_config("llava-next-34b").num_image_tokens + LLAVA_TEXT
    ctx, rec = family_oneshot("llava-next-34b", LLAVA_B, t_llava)
    oneshot_launches(rec)
    time_config_kernels(ctx, rows, "llava-next-34b (cut)", ((0, "_llava"),), LLAVA_B, t_llava)
    records["llava-next-34b"] = rec
    p22["llava-next-34b"] = _p22_ref(ctx)
    ctx = None
    free()
    log(f"[p17] phase 17 took {time.perf_counter() - t0:.1f} s; launches {launches}")
    log("[p17] summary " + json.dumps(records))
    return p22

# ---------------------------------------------------------------------------
# phase 18: weight-only int8 serving, training, the training CLI
# ---------------------------------------------------------------------------

# the int8 smoke variant (card against CPU): minitron-8b's smoke config
# widened until its projections cross quantize_serve_params' 2^16-element
# threshold; vocab 128 keeps the embedding and head plain, so the run stays
# fp32 (a quantized embedding makes the activations bf16)
INT8_SMOKE = dict(d_model=256, d_ff=512, head_dim=64, vocab_size=128)
TRAIN_ARCH = "granite-3-2b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 2, 4096, 4  # train_4k's sequence length
# cut to 10 of its 40 layers since the script took 1160 s with phase 24 (the
# full depth took 23.1 s: 4.941 s a step on an NVIDIA H100 80GB HBM3,
# 700.00 W, recorded in PERF.md)
TRAIN_LAYERS = 10
TRAIN_SMOKE = ("granite-3-2b", "granite-moe-1b-a400m", "mamba2-1.3b", "hymba-1.5b",
               "whisper-small", "llava-next-34b")
# the flash backward against autograd through dense_attention at one of
# granite-3-2b's layers: (window, softcap)
FLASH_CASES = ((0, 0.0), (1024, 0.0), (0, 50.0), (1024, 50.0))


def _tree_bytes(tree) -> int:
    """Bytes of a serve tree's tensors (an int8 weight: codes and scale)."""
    from repro_torch.serving.quant import QTensor
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tree_bytes(v) for v in tree)
    if isinstance(tree, QTensor):
        return _tree_bytes(tree.q) + _tree_bytes(tree.scale)
    return tree.numel() * tree.element_size()


def int8_smoke_parity():
    """Phase 18 (a), first part: the widened minitron-8b smoke config
    (`INT8_SMOKE`, fp32) with int8 serve params on the card against the
    port's CPU path, same weights: one-shot fairkv_dp, identical tokens and
    lengths, logits within 1e-3.  Returns the card run's launches."""
    import numpy as np
    from repro_torch import interop
    from repro_torch.api import CompressionConfig, Engine, EngineConfig, PlannerConfig
    from repro_torch.serving.quant import has_qtensor, quantize_serve_params
    out, params, got = {}, None, {}
    for dev in ("cpu", "cuda"):
        cfg = EngineConfig.smoke(
            ARCH, n_shards=4, max_seq_len=64, device=dev,
            compression=CompressionConfig(policy="ada_snapkv", budget=12, alpha_max=2.0,
                                          obs_window=8, sink=2, decode_margin=8),
            planner=PlannerConfig(mode="fairkv_dp", extra_copies=4, batch_cap=2))
        cfg = cfg.replace(model=cfg.model.with_overrides(**INT8_SMOKE))
        if params is None:
            params = Engine.build(cfg).params
        eng = Engine.build(cfg, params=interop.to_torch(interop.to_numpy(params), dev))
        eng.sp = quantize_serve_params(eng.sp)
        if not has_qtensor(eng.sp):
            fail("[p18] (a) the int8 smoke config quantized nothing")
        toks = np.random.default_rng(SEED).integers(0, 128, size=(2, 40)).astype(np.int32)
        res, launches = _count(lambda: eng.generate(toks, 6))
        out[dev] = res
        if dev == "cuda":
            got = launches
    a, b = out["cpu"], out["cuda"]
    gap = float(np.abs(a.logits - b.logits).max())
    if not (np.array_equal(a.tokens, b.tokens) and np.array_equal(a.lengths, b.lengths)
            and gap < 1e-3):
        fail(f"[p18] (a) int8 smoke: card vs CPU tokens equal "
             f"{np.array_equal(a.tokens, b.tokens)}, lengths equal "
             f"{np.array_equal(a.lengths, b.lengths)}, max |dlogits| {gap:.3e} (bar 1e-3)")
    log(f"[p18] (a) int8 smoke ({INT8_SMOKE}): card == CPU tokens and lengths; "
        f"max |dlogits| {gap:.3e}")
    return got


def int8_main_path(rows):
    """Phase 18 (a): minitron-8b at full width and depth with int8 weights
    (`quantize_serve_params` on each engine's serve tree), phase 5's plan
    and compression, one-shot B = 8 x T = 2048, 32 new tokens, through the
    local executor (graphed decode) and kernels 1 and 2.  The bf16 sha run
    comes first and its tokens teacher-force the int8 runs under sha and
    fairkv_dp.  Bars: launches (kernel 1 n_layers x GEN, kernel 2 n_layers
    per run), lengths bitwise across the planners, the int8 plans' logit
    gap under n_layers 2^-8 max|logit|, eager == graphed tokens and
    lengths, the mesh executor refusing the tree.  Reported: argmax
    agreement and logit gap against bf16, the weights' bytes in int8 and
    bf16, step host / device ms, kernel 1's ms, max_memory_allocated.
    Kernels 1 and 2 timed on the int8 run's cache and at its prefill shape
    (``*_int8w`` keys).  Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.api import Engine
    from repro_torch.configs.base import InputShape
    from repro_torch.exec.mesh import MeshExecutor
    from repro_torch.launch.mesh import Group, Mesh
    from repro_torch.serving.quant import quantize_serve_params
    from repro_torch.training.data import SyntheticLM
    t0 = time.perf_counter()
    cfg = main_config(full_depth=True)
    m = cfg.model
    data = SyntheticLM(m, InputShape("chip_smoke", T, B, "prefill"))
    prompts = data.get_batch(0)["tokens"]
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    probe = Engine.build(cfg)
    params = probe.params
    profile = probe.measure_profile(data.get_batch(123)["tokens"])
    del probe
    launches, runs, rec = {}, {}, {"runs": {}}
    eng = None
    for name, mode, ch, quant in (("bf16 sha", "sha", 0, False), ("int8 sha", "sha", 0, True),
                                  ("int8 fairkv_dp", "fairkv_dp", 4, True)):
        eng = None
        gc.collect()
        torch.cuda.empty_cache()
        eng = Engine.build(cfg.replace(planner=planner(mode, ch)), params=params,
                           profile=profile)
        if quant:
            rec["weights_bytes_bf16"] = _tree_bytes(eng.sp)
            eng.sp = quantize_serve_params(eng.sp)
            rec["weights_bytes_int8"] = _tree_bytes(eng.sp)
        teacher = None if not runs else runs["bf16 sha"].tokens[:, :GEN]
        res, got = _count(lambda: eng.generate(prompts, GEN, teacher_tokens=teacher))
        if got["fairkv_decode"] != m.n_layers * GEN or got["snapkv_scores"] != m.n_layers:
            fail(f"[p18] (a) {name}: launches {got}, expected fairkv_decode {m.n_layers} x "
                 f"{GEN}, snapkv_scores {m.n_layers}")
        if res.logits.shape != (B, GEN + 1, m.padded_vocab) or not np.isfinite(res.logits).all():
            fail(f"[p18] (a) {name}: logits {res.logits.shape} or not finite")
        for k, v in got.items():
            launches[k] = launches.get(k, 0) + v
        runs[name] = res
        dev_ms, k1_ms = _step_times(eng)
        rec["runs"][name] = {"prefill_s": res.prefill_s,
                             "step_ms_host": 1e3 * statistics.median(res.step_s),
                             "step_ms_device": dev_ms, "kernel1_ms_per_step": k1_ms}
    a, b = runs["int8 sha"], runs["int8 fairkv_dp"]
    if not np.array_equal(a.lengths, b.lengths):
        fail("[p18] (a) int8: lengths differ between sha and fairkv_dp")
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(a.logits).max())
    gap = float(np.abs(a.logits - b.logits).max())
    if not gap < tol:
        fail(f"[p18] (a) int8: logit gap fairkv_dp vs sha {gap} >= {tol}")
    ref = runs["bf16 sha"]
    for name in ("int8 sha", "int8 fairkv_dp"):
        r = runs[name]
        rec["runs"][name].update(
            gap_to_bf16=float(np.abs(r.logits - ref.logits).max()),
            argmax_agree_bf16=float((r.logits.argmax(-1) == ref.logits.argmax(-1)).mean()))
    rec.update(plan_gap=gap, plan_bar=tol)
    # the mesh executor refuses a quantized tree (checked before any step)
    fake = Mesh(rank=0, world=1, model=1, data=1, model_idx=0, data_idx=0,
                model_group=Group(None, "model", 1, 0, "gloo"),
                data_group=Group(None, "data", 1, 0, "gloo"), device=torch.device("cuda"),
                backend="gloo")
    try:
        MeshExecutor(m, cfg.compression, mesh=fake)._check(eng.sp, eng.pa)
    except NotImplementedError as e:
        rec["mesh_refusal"] = str(e)
    else:
        fail("[p18] (a) the mesh executor accepted int8 slot weights")
    # eager against graphed, fairkv_dp, teacher-forced alike
    eng.executor = eager_executor(eng.cfg)
    eager, got = _count(lambda: eng.generate(prompts, GEN, teacher_tokens=ref.tokens[:, :GEN]))
    for k, v in got.items():
        launches[k] = launches.get(k, 0) + v
    if not (np.array_equal(eager.tokens, b.tokens) and np.array_equal(eager.lengths, b.lengths)):
        fail("[p18] (a) int8: eager tokens or lengths differ from the graphed run's")
    rec.update(eager_logits_bitwise=bool(np.array_equal(eager.logits, b.logits)),
               eager_logit_gap=float(np.abs(eager.logits - b.logits).max()),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               seconds=time.perf_counter() - t0)
    ctx = {"cfg": eng.cfg, "cache": eng.state.cache}
    del eng
    time_config_kernels(ctx, rows, "minitron-8b int8 weights", ((0, "_int8w"),), B, T)
    log(f"[p18] (a) minitron-8b int8 weights (32 layers, B={B}, T={T}, {GEN} new tokens): "
        + "; ".join(f"{n}: prefill {r['prefill_s']:.2f} s, step {r['step_ms_host']:.2f} ms "
                    f"host / {r['step_ms_device']:.2f} ms device (kernel 1 "
                    f"{r['kernel1_ms_per_step']:.3f} ms)"
                    + (f", vs bf16: logit gap {r['gap_to_bf16']:.4f}, argmax agreement "
                       f"{r['argmax_agree_bf16']:.4f}" if "gap_to_bf16" in r else "")
                    for n, r in rec["runs"].items())
        + f"; lengths plan-invariant, plan logit gap {gap:.4f} (bar {tol:.4f}); weights "
        f"{rec['weights_bytes_int8'] / 2**30:.2f} GiB int8 vs "
        f"{rec['weights_bytes_bf16'] / 2**30:.2f} GiB bf16; eager == graphed tokens and "
        f"lengths (logits bitwise {rec['eager_logits_bitwise']}, gap "
        f"{rec['eager_logit_gap']:.4f}); mesh refuses: {rec['mesh_refusal']!r}; "
        f"max_memory_allocated {rec['max_memory_allocated'] / 2**30:.2f} GiB; "
        f"{rec['seconds']:.1f} s")
    log("[p18] (a) summary " + json.dumps(rec))
    return launches


def flash_backward_check():
    """Phase 18 (b), first part: `flash_attention_vjp`'s dq / dk / dv on the
    card against autograd through `dense_attention`, fp32 inputs at one of
    granite-3-2b's layers (B 1, T 4096, 32 / 8 heads, Dh 64), each
    (window, softcap) of `FLASH_CASES`; bar: each within 1e-3 max|grad|."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    m = get_config(TRAIN_ARCH)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 11)
    Tq, Hq, Hkv, Dh = TRAIN_S, m.n_heads, m.n_kv_heads, m.head_dim
    q = torch.randn((1, Tq, Hq, Dh), generator=gen, device="cuda")
    k = torch.randn((1, Tq, Hkv, Dh), generator=gen, device="cuda")
    v = torch.randn((1, Tq, Hkv, Dh), generator=gen, device="cuda")
    w = torch.randn((1, Tq, Hq, Dh), generator=gen, device="cuda")
    pos = torch.arange(Tq, dtype=torch.int32, device="cuda")[None]
    errs = []
    for window, cap in FLASH_CASES:
        grads = []
        for fn in (lambda *a: L.flash_attention_vjp(*a, window, cap, True, 1024),
                   lambda *a: L.dense_attention(*a, window=window, attn_cap=cap)):
            xs = [t.clone().requires_grad_(True) for t in (q, k, v)]
            (fn(*xs, pos, pos) * w).sum().backward()
            grads.append([x.grad for x in xs])
            del xs
        for name, g, d in zip(("dq", "dk", "dv"), *grads):
            err = float((g - d).abs().max())
            bar = 1e-3 * float(d.abs().max())
            if not err < bar:
                fail(f"[p18] (b) flash backward, window {window}, softcap {cap}: {name} "
                     f"differs by {err} >= {bar}")
            errs.append(err / float(d.abs().max()))
        del grads
        gc.collect()
        torch.cuda.empty_cache()
    log(f"[p18] (b) flash_attention_vjp backward vs autograd through dense_attention at "
        f"(B 1, T {Tq}, {Hq}/{Hkv} heads, Dh {Dh}) fp32, (window, softcap) in {FLASH_CASES}: "
        f"max |d grad| / max |grad| = {max(errs):.3e} (bar 1e-3)")


def train_smoke_parity():
    """Phase 18 (b), second part: the smoke variants of the six families'
    training (fp32, same initial weights) on the card against the CPU: the
    loss after two steps of `make_train_step` within 1e-3."""
    import torch
    from repro_torch import interop
    from repro_torch.configs import InputShape, get_smoke_config
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params
    from repro_torch.training import (OptimizerConfig, SyntheticLM, init_optimizer,
                                      make_train_step)
    gaps = {}
    for arch in TRAIN_SMOKE:
        cfg = get_smoke_config(arch)
        data = SyntheticLM(cfg, InputShape("chip_smoke", 32, 2, "train"))
        host = init_params(cfg, SEED, dtype=torch.float32, device="cpu")
        losses = {}
        for dev in ("cpu", "cuda"):
            params = interop.to_torch(interop.to_numpy(host), dev)
            opt = init_optimizer(params)
            step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                        total_steps=2), remat=True)
            for s in range(2):
                params, opt, met = step(params, opt, device_batch(data.get_batch(s), dev))
            losses[dev] = float(met["loss"])
        gaps[arch] = abs(losses["cpu"] - losses["cuda"])
        if not gaps[arch] < 1e-3:
            fail(f"[p18] (b) {arch} smoke training: card loss {losses['cuda']} vs CPU "
                 f"{losses['cpu']} after 2 steps (bar 1e-3)")
    log(f"[p18] (b) smoke training, card == CPU loss after 2 steps: "
        f"{ {a: float(f'{g:.3e}') for a, g in gaps.items()} }")


def train_full_width():
    """Phase 18 (b): granite-3-2b at full width and depth, bf16 params,
    fp32 master / mu / nu, B = 2 x S = 4096 (past flash_threshold, so the
    recomputing flash backward runs), `SyntheticLM` batches, remat, 4
    steps of `make_train_step` through `TrainingSupervisor.run` (no
    checkpoint).  Bars: finite loss and grad norm at every step, params
    still bf16, master still fp32.  Reports step s, tokens/s, 6 N tokens /
    step / 989e12, max_memory_allocated and the loss per step."""
    import math
    import os
    import tempfile

    import torch
    from repro_torch.configs import InputShape, get_config
    from repro_torch.launch.train import device_batch
    from repro_torch.models import init_params
    from repro_torch.training import (OptimizerConfig, SupervisorConfig, SyntheticLM,
                                      TrainingSupervisor, init_optimizer, make_train_step)
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH).with_overrides(n_layers=TRAIN_LAYERS)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, SEED, dtype=torch.bfloat16, device="cuda",
                         max_seq_len=TRAIN_S)
    n_params = _n_params(params)
    state = {"params": params, "opt": init_optimizer(params)}
    del params
    step = make_train_step(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=TRAIN_STEPS), remat=True)
    data = SyntheticLM(cfg, InputShape("chip_smoke", TRAIN_S, TRAIN_B, "train"))
    times, mets = [], []

    def one_step(st, batch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p, o, met = step(st["params"], st["opt"], device_batch(batch, "cuda"))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        mets.append({k: float(v) for k, v in met.items()})
        return {"params": p, "opt": o}, met

    with tempfile.TemporaryDirectory() as d:
        sup = TrainingSupervisor(SupervisorConfig(checkpoint_dir=os.path.join(d, "ck"),
                                                  checkpoint_every=TRAIN_STEPS + 1))
        _, state, _ = sup.run(state, one_step, data.get_batch, TRAIN_STEPS)
    for i, met in enumerate(mets):
        if not (math.isfinite(met["loss"]) and math.isfinite(met["grad_norm"])):
            fail(f"[p18] (b) step {i + 1}: loss {met['loss']}, grad norm {met['grad_norm']}")
    leaves = [x for pl in state["params"]["layers"] for x in pl.values()]
    if any(x.dtype != torch.bfloat16 for x in leaves + [state["params"]["embed"]]):
        fail("[p18] (b) params are not all bf16 after the steps")
    if any(x.dtype != torch.float32 for x in state["opt"].master["layers"][0].values()):
        fail("[p18] (b) the master weights are not fp32 after the steps")
    step_s = statistics.median(times[1:])
    tokens = TRAIN_B * TRAIN_S
    rec = {"arch": cfg.name, "layers": cfg.n_layers, "params": n_params, "batch": TRAIN_B,
           "seq": TRAIN_S, "step_s": times, "step_s_median_after_first": step_s,
           "tokens_per_s": tokens / step_s,
           "model_flops_share_bf16_peak": 6 * n_params * tokens / step_s / BF16_FLOP_PER_S,
           "loss": [mt["loss"] for mt in mets], "grad_norm": [mt["grad_norm"] for mt in mets],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "seconds": time.perf_counter() - t0}
    log(f"[p18] (b) {cfg.name} training at full width ({cfg.n_layers} of "
        f"{get_config(TRAIN_ARCH).n_layers} layers, "
        f"{n_params / 1e9:.2f} B parameters, bf16 params, fp32 master / mu / nu, B={TRAIN_B} "
        f"x S={TRAIN_S}, remat): step {step_s:.3f} s (median of steps 2-{TRAIN_STEPS}; "
        f"first {times[0]:.3f} s), {rec['tokens_per_s']:.0f} tokens/s, 6 N tokens / step = "
        f"{100 * rec['model_flops_share_bf16_peak']:.2f}% of 989 TFLOP/s, loss "
        f"{[round(x, 4) for x in rec['loss']]}, max_memory_allocated "
        f"{rec['max_memory_allocated'] / 2**30:.2f} GiB; {rec['seconds']:.1f} s")
    log("[p18] (b) summary " + json.dumps(rec))


def train_cli_restart_start():
    """Phase 18 (c), started from a thread: ``python -m
    repro_torch.launch.train --arch granite-3-2b --smoke --steps 6
    --ckpt-every 3`` on the card in a subprocess, then again with
    ``--resume`` after the checkpoints past step 3 are removed: the step-6
    tree bitwise the uninterrupted run's.  Returns ``join()``, which logs
    the result (or raises what the runs raised).  ``CUBLAS_WORKSPACE_CONFIG``
    is set in the subprocesses' environment (the CLI turns on deterministic
    algorithms: on the card the embedding's backward otherwise accumulates
    with atomics)."""
    import threading

    box, procs = {}, []
    atexit.register(lambda: [(p.kill(), p.wait()) for p in procs if p.poll() is None])

    def work():
        try:
            train_cli_restart(procs)
        except BaseException as e:  # handed to the caller by join()
            box["error"] = e

    th = threading.Thread(target=work, daemon=True)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]

    return join


def train_cli_restart(procs):
    """Phase 18 (c)'s two runs and check (see `train_cli_restart_start`);
    each subprocess is appended to ``procs``."""
    import shutil

    import numpy as np
    ckpt = ROOT / "build" / "p18_train_ckpt"
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUBLAS_WORKSPACE_CONFIG=":4096:8")
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", TRAIN_ARCH, "--smoke",
           "--steps", "6", "--ckpt-every", "3", "--ckpt-dir", str(ckpt)]

    def run(*extra):
        t = time.perf_counter()
        proc = subprocess.Popen(cmd + list(extra), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        procs.append(proc)
        out, err = proc.communicate(timeout=300)
        if proc.returncode != 0:
            fail(f"[p18] (c) {' '.join(cmd[2:] + list(extra))} exited {proc.returncode}: "
                 f"{err[-3000:]}")
        return out, time.perf_counter() - t

    def leaves(step_dir):
        with open(step_dir / "manifest.json") as f:
            names = [x["name"] for x in json.load(f)["leaves"]]
        return {n: np.load(step_dir / (n + ".npy")) for n in names}

    first, s1 = run()
    full = leaves(ckpt / "step_00000006")
    shutil.rmtree(ckpt / "step_00000006")
    second, s2 = run("--resume")
    if "resumed from step 3" not in second:
        fail(f"[p18] (c) the resumed run did not start at step 3: {second[-500:]}")
    again = leaves(ckpt / "step_00000006")
    differ = [n for n in full if n not in again or not np.array_equal(full[n], again[n])]
    if differ or len(again) != len(full):
        fail(f"[p18] (c) the resumed step-6 tree differs from the uninterrupted run's in "
             f"{len(differ)} leaves, e.g. {differ[:3]}")
    shutil.rmtree(ckpt, ignore_errors=True)
    log(f"[p18] (c) launch.train --smoke on the card: {first.strip().splitlines()[-1]} "
        f"({s1:.1f} s); resumed from step 3 ({s2:.1f} s): the step-6 tree bitwise equal "
        f"({len(full)} leaves)")


def p18_runs(rows):
    """Phase 18: (a) int8 weights on the main path; (b) training at full
    width and depth, with the flash backward and the families' smoke
    variants checked on the card; (c) the training CLI and a restart,
    started last and left running: returns its ``join()``.  Prints the
    phase's time and launches (apart from the kernel table)."""
    import torch
    t0 = time.perf_counter()
    launches = int8_smoke_parity()
    for k, v in int8_main_path(rows).items():
        launches[k] = launches.get(k, 0) + v
    gc.collect()
    torch.cuda.empty_cache()
    flash_backward_check()
    train_smoke_parity()
    train_full_width()
    gc.collect()
    torch.cuda.empty_cache()
    join = train_cli_restart_start()
    log(f"[p18] phase 18 took {time.perf_counter() - t0:.1f} s before (c); launches {launches}")
    return join


# ---------------------------------------------------------------------------
# phase 19: the production dry run on fake tensors
# ---------------------------------------------------------------------------

P19_AUDITS = ("minitron-8b", "qwen1.5-110b")
P19_PREDICTION_TOL = 0.10  # predicted peak bytes within 10% of the card's


def p19_scratch_formulas():
    """The fake implementations' scratch sizes equal the libraries' at the
    main path's, the families' and the dry run's shapes."""
    from repro_torch.kernels import fairkv_decode as K1
    from repro_torch.kernels import paged_fairkv_decode as KP
    from repro_torch.kernels import snapkv_select as K2
    lib1, libp, libq, lib2 = (K1._launcher(), KP._launcher(KP.NAME), KP._launcher(KP.NAME_MQ),
                              K2._launcher())
    n = 0
    if lib1.fairkv_decode_segment_columns() != K1.SEG:
        fail(f"the library's segment ({lib1.fairkv_decode_segment_columns()} columns) is not "
             f"the wrapper's {K1.SEG}")
    for (Bq, S, G, Dh), C in itertools.product(
            ((B, 16, 4, 128), (8, 1, 4, 128), (8, 1, 8, 128), (4, 16, 2, 256), (8, 16, 5, 64),
             (2, 16, 7, 128)), (C_MAIN, 1600, K1.SEG, K1.SEG + 1, P21_CAP + MARGIN)):
        want = (lib1.fairkv_decode_scratch_floats(Bq, S, G, Dh, C),
                lib1.fairkv_decode_counters(Bq, S, C),
                libp.paged_fairkv_decode_scratch_floats(Bq, S, G, Dh, C),
                libp.paged_fairkv_decode_counters(Bq, S, C))
        if want != (K1.scratch_floats(Bq, S, G, Dh, C), K1.counters(Bq, S, C),
                    KP.scratch_floats(Bq, S, 1, G, Dh, C), KP.counters(Bq, S, 1, C)):
            fail(f"fake scratch size differs from the library's at {(Bq, S, G, Dh, C)}: {want}")
        for Q in range(1, 41 // G + 1):
            if (libq.paged_fairkv_decode_mq_scratch_floats(Bq, S, Q, G, Dh, C),
                    libq.paged_fairkv_decode_mq_counters(Bq, S, Q, C)) != (
                    KP.scratch_floats(Bq, S, Q, G, Dh, C), KP.counters(Bq, S, Q, C)):
                fail(f"fake multi-query scratch differs from the library's at "
                     f"{(Bq, S, Q, G, Dh, C)}")
            n += 1
    for Bq, Hkv, Tk in ((B, 8, T), (1, 8, T), (2, 8, 32768), (1, 8, 512), (4, 8, 4608),
                        (8, 5, 2048), (2, 8, 3904), (1, 1, 64)):
        if lib2.snapkv_scores_splits(Bq, Hkv, Tk) != K2.splits(Bq, Hkv, Tk):
            fail(f"fake snapkv splits differ from the library's at {(Bq, Hkv, Tk)}")
        n += 1
    log(f"[p19] fake implementations' scratch equals the libraries' at {n} shapes")


def p19_audits():
    """Phase 19 (a): the executor audit on the production mesh."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun
    for arch in P19_AUDITS:
        m = get_config(arch)
        rec = dryrun.run_executor_audit(arch)
        g = rec["collectives_by_group"]
        per = SHAPES["decode_32k"].global_batch // 16 * m.d_model * 2
        ar = g.get("model", {}).get("all_reduce", {})
        if ar.get("calls") != m.n_layers or ar.get("bytes") != m.n_layers * per:
            fail(f"[p19] {arch}: {ar} all-reduce over model, expected {m.n_layers} calls of "
                 f"{per} B")
        if "all_gather" in g.get("model", {}):
            fail(f"[p19] {arch}: an all-gather over model in the decode step: {g['model']}")
        data = g.get("data", {})
        if set(data) != {"all_gather"} or data["all_gather"]["calls"] != 2:
            fail(f"[p19] {arch}: over data the decode step should gather its tokens and "
                 f"logits only, got {data}")
        mem = rec["memory"]
        log(f"[p19] (a) {arch} decode_32k on (data 16, model 16): {ar['calls']} all-reduces "
            f"over model of {per} B ({ar['bytes']} B), no all-gather over model, data "
            f"{data['all_gather']['calls']} output gathers ({data['all_gather']['bytes']} B); "
            f"rank 0 args {mem['argument_bytes']} B, peak {mem['peak_bytes']} B, fits "
            f"{rec['fits']} ({rec['device_bytes']} B)")


def p19_prediction():
    """Phase 19 (b): predicted peak bytes of phase 5's one-shot steps on a
    (1, 1) mesh against the card's."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.cache.slot_cache import PlanArrays
    from repro_torch.configs.base import InputShape
    from repro_torch.core.planner import build_plan
    from repro_torch.core.profiles import synthetic_profile
    from repro_torch.distributed import step_stats
    from repro_torch.exec.mesh import MeshExecutor
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh, make_production_mesh
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as S

    cfg = main_config().replace(planner=planner("fairkv_dp", 4))
    m, ccfg = cfg.model, cfg.compression
    plan = build_plan(synthetic_profile(m.n_layers, m.n_kv_heads, budget=BUDGET, skew=1.0,
                                        seed=SEED), N_SHARDS, cfg.planner)
    with fake_process_group(1), step_stats.fake_tensors(), torch.inference_mode():
        mesh = make_production_mesh(model=1, data=1)
        ex = dryrun._executor(m, mesh, ccfg)
        a = specs.executor_args(m, InputShape("p19", T, B, "prefill"), mesh, ex, plan, ccfg)
        (state, _, _), pre = step_stats.measure(ex._prefill, (a["sp"], a["pa"], a["batch"]),
                                                a["sp"], a["batch"], a["pa"], None, None)
        _, dec = step_stats.measure(ex._decode, (a["sp"], state, a["pa"]), a["sp"], state,
                                    a["pa"], None, None)
        del a, state
    predicted = {"prefill": pre.peak_bytes, "decode": dec.peak_bytes}

    tokens = np.random.default_rng(SEED).integers(0, m.vocab_size, (B, T))
    dist.init_process_group("gloo", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(1, 1, device="cuda")
        ex = MeshExecutor(m, ccfg, mesh=mesh, graphs=False)
        gc.collect()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        params = init_params(m, SEED, torch.bfloat16, device="cuda")
        sp = S.slotify_params(params, plan, m, slots=ex.local_slots(plan.n_slots))
        del params
        pa = PlanArrays.from_plan(plan, device="cuda")
        batch = {"tokens": torch.as_tensor(tokens, dtype=torch.int64, device="cuda")}
        real = {}
        with torch.inference_mode():
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            state, logits, lengths = ex._prefill(sp, batch, pa, None, None)
            torch.cuda.synchronize()
            real["prefill"] = torch.cuda.max_memory_allocated() - base
            if not torch.isfinite(logits).all():
                fail("[p19] (b) the real prefill's logits are not finite")
            del batch, logits, lengths
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            _, logits = ex._decode(sp, state, pa, None, None)
            torch.cuda.synchronize()
            real["decode"] = torch.cuda.max_memory_allocated() - base
            if not torch.isfinite(logits).all():
                fail("[p19] (b) the real decode step's logits are not finite")
        del sp, pa, state, logits
    finally:
        dist.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    for step in ("prefill", "decode"):
        gap = abs(predicted[step] - real[step]) / real[step]
        log(f"[p19] (b) {step}: predicted peak {predicted[step]} B on fake tensors, "
            f"max_memory_allocated {real[step]} B on the card (above the memory allocated "
            f"before the step's arguments): gap {100 * gap:.2f}% (bar "
            f"{100 * P19_PREDICTION_TOL:.0f}%)")
        if gap > P19_PREDICTION_TOL:
            fail(f"[p19] (b) {step}: predicted peak {predicted[step]} B is {100 * gap:.1f}% "
                 f"off the card's {real[step]} B")


P19_DRY = ROOT / "chiprun_out" / "dryrun_p19"


def p19_sweep_start():
    """Start (c)'s single-mesh sweep of the ten archs at decode_32k in a
    subprocess (host only, one thread; ~54 s of host time, off the main
    process's); returns it."""
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from repro_torch.configs import ALL_ARCHS; "
            "from repro_torch.launch import dryrun as d; "
            f"a = d.sweep(ALL_ARCHS, ['decode_32k'], [False], 'fairkv_dp', {str(P19_DRY)!r}, "
            "dev_bytes=d.H100_BYTES); "
            "sys.exit(a['counts']['fail'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def p19_runs(sweep):
    """Phase 19: the dry run's audit, its prediction against the card, and
    the single-mesh sweep at decode_32k (from ``sweep``, `p19_sweep_start`'s
    subprocess)."""
    from repro_torch.configs import ALL_ARCHS
    t0 = time.perf_counter()
    p19_scratch_formulas()
    p19_audits()
    p19_prediction()
    t1 = time.perf_counter()
    out, _ = sweep.communicate(timeout=900)
    records = [json.loads((P19_DRY / f"{arch}__decode_32k__single.json").read_text())
               for arch in ALL_ARCHS]
    c = {k: sum(r["status"] == k for r in records) for k in ("ok", "skipped", "fail")}
    if sweep.returncode != 0 and not c["fail"]:
        fail(f"[p19] (c) the sweep's subprocess failed:\n{out[-3000:]}")
    res = {"records": records}
    for rec in res["records"]:
        ex = rec.get("executed", {}).get("memory", {})
        log(f"[p19] (c) {rec['arch']} decode_32k single: {rec['status']}, rules args "
            f"{rec.get('memory', {}).get('argument_bytes')} B, cell step peak "
            f"{ex.get('peak_bytes')} B, fits {rec.get('fits')}")
    log(f"[p19] (c) sweep of {len(ALL_ARCHS)} archs at decode_32k on (data 16, model 16): "
        f"{c}, read {time.perf_counter() - t1:.1f} s after the audits")
    if c["fail"]:
        fail(f"[p19] (c) {c['fail']} dry-run cells failed")
    log(f"[p19] phase 19 took {time.perf_counter() - t0:.1f} s")
    return res["records"]


# ---------------------------------------------------------------------------
# phase 20: the serve cells' step under serve_rules
# ---------------------------------------------------------------------------

P20_MODEL = 2  # (b): two gloo ranks sharing the card


def p20_build(mesh, ref, init_device=None):
    """Phase 5's one-shot (its config, plan, prompts) as the serve cells'
    step on ``mesh``'s rank under ``serve_rules``: this rank's shards of
    the seed weights (built on ``init_device``, default the mesh's device,
    then moved there), plan arrays and prompt rows, and the prefill and
    decode steps (`repro_torch.launch.specs.serve_step`).  Also returns the
    bytes of the rank's MLP and vocab weights and of the whole tree's, and
    the global row count.  ``ref["prompts"]`` is the tokens or a batch
    dict (phase 22: a VLM's image embeddings, an encoder-decoder's
    frames); an attention-free model has no plan."""
    import dataclasses

    import torch
    from repro_torch.cache.slot_cache import PlanArrays
    from repro_torch.core.planner import build_plan
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import serve_rules
    from repro_torch.launch import specs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as S

    cfg = ref["cfg"]
    m, ccfg = cfg.model, cfg.compression
    plan = None if m.attention_free else build_plan(ref["profile"], cfg.n_shards, cfg.planner)
    rules = serve_rules(mesh)
    params = init_params(m, cfg.seed, torch.bfloat16, device=init_device or mesh.device,
                         max_seq_len=cfg.max_seq_len)
    sp = S.slotify_params(params, plan, m)
    del params
    sp_spec = tree_specs(sp, rules, "serve")

    def mlp_vocab(tree):  # the MLP's (or the experts' and router's) and vocab weights
        leaves = [tree["embed"], tree.get("head")] + [
            pl.get(k) for pl in tree["layers"]
            for k in ("w1", "w2", "w3", "we1", "we2", "we3", "router")]
        return sum(t.numel() * t.element_size() for t in leaves if t is not None)

    whole = mlp_vocab(sp)
    sp = local_shard(sp, sp_spec, mesh)
    dev = sp["final_norm"].device
    pa = None
    if plan is not None:
        pa = PlanArrays.from_plan(plan, device=dev)
        pa = local_shard({f.name: getattr(pa, f.name) for f in dataclasses.fields(pa)},
                         specs.plan_specs(plan, rules), mesh)
    prompts = ref["prompts"] if isinstance(ref["prompts"], dict) else {"tokens": ref["prompts"]}
    batch = {k: torch.as_tensor(v, dtype=torch.int64 if k == "tokens" else None, device=dev)
             for k, v in prompts.items()}
    n_rows = batch["tokens"].shape[0]
    batch = local_shard(batch, specs.batch_specs(batch, rules), mesh)
    if init_device is not None:  # fake tensors built on the host: to the mesh's device
        sp, pa, batch = (specs._to_device(x, mesh.device) for x in (sp, pa, batch))
    n_slots = 0 if plan is None else plan.n_slots
    steps = {k: specs.serve_step(k, m, ccfg, mesh, rules, sp_spec, n_slots, n_rows)
             for k in ("prefill", "decode")}
    return {"sp": sp, "pa": pa, "batch": batch, "steps": steps, "n_rows": n_rows,
            "mlp_vocab_bytes": (mlp_vocab(sp), whole)}


def p20_oneshot(mesh, ref, memory=False):
    """Phase 5's one-shot (prefill, then ``GEN`` steps fed phase 5's teacher
    tokens) through the cell step on ``mesh``'s rank.  Returns its tokens,
    logits (the rank's vocab columns), lengths, one decode step's
    collectives, the launches, the final state's SSD, conv and cross
    attention tensors (the rank's shards, on the host) and, with
    ``memory``, each step's ``max_memory_allocated`` above the memory
    allocated before its arguments (prefill, then the first decode
    step)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.distributed import comm
    from repro_torch.kernels import build

    base = torch.cuda.memory_allocated() if memory else 0
    a = p20_build(mesh, ref)
    sp, pa, steps = a["sp"], a["pa"], a["steps"]
    teacher = torch.as_tensor(ref["teacher"], dtype=torch.int64, device=mesh.device)
    rows = mesh.rows(a["n_rows"])
    out = {"mlp_vocab_bytes": a["mlp_vocab_bytes"], "peak": {}}
    build.reset_launches()
    with torch.inference_mode():
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, logits, lengths = steps["prefill"](sp, a["batch"], pa)
        torch.cuda.synchronize()
        out["prefill_s"] = time.perf_counter() - t0
        out["peak"]["prefill"] = torch.cuda.max_memory_allocated() - base
        tokens, logit_rows = [state.last_tokens.cpu().numpy()], [logits.cpu().numpy()]
        out["lengths"] = lengths.cpu().numpy()
        del a, logits, lengths
        step_s = []
        for t in range(GEN):
            state = dataclasses.replace(state, last_tokens=teacher[rows, t])
            if t == 0:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = comm.snapshot()
            t0 = time.perf_counter()
            state, lg = steps["decode"](sp, state, pa)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if t == 0:
                out["peak"]["decode"] = torch.cuda.max_memory_allocated() - base
                out["collectives"] = comm.by_kind(comm.since(before))
            tokens.append(state.last_tokens.cpu().numpy())
            logit_rows.append(lg.cpu().numpy())
    out.update(tokens=np.stack(tokens, axis=1), logits=np.stack(logit_rows, axis=1),
               step_ms=1e3 * statistics.median(step_s), launches=dict(build.LAUNCHES),
               state=_p22_states(state))
    return out


def p20_contract(name, coll, m, model, tag="[p20]"):
    """The decode contract on one rank (``B`` rows, data 1): 2·L + 1
    all-reduces of (B, d_model) over model, one all-gather of (B, 2 x
    model) argmax pairs (and an MoE config's router gathers), nothing over
    data."""
    from repro_torch.launch import dryrun
    got = dryrun.decode_contract(coll, m, B, model)
    if not all(got.values()):
        fail(f"{tag} {name}: decode collectives {coll} break the contract {got}")


def p20_compare(name, run, ref, m):
    """Tokens equal, lengths bitwise and the logit gap under the plan bar
    against phase 5's local fairkv_dp run; returns (bitwise, gap, bar)."""
    import numpy as np
    slot = ref["slot_dp"]
    if run["logits"].shape != slot.logits.shape or not np.isfinite(run["logits"]).all():
        fail(f"[p20] {name}: logits of shape {run['logits'].shape} (want "
             f"{slot.logits.shape}) or not finite")
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(slot.logits).max())
    gap = float(np.abs(run["logits"] - slot.logits).max())
    if not gap < tol:
        fail(f"[p20] {name}: logit gap {gap} >= the plan bar {tol}")
    bitwise = (np.array_equal(run["logits"], slot.logits)
               and np.array_equal(run["tokens"], slot.tokens))
    return bitwise, gap, tol


def p20_nccl(ref, tag="[p20] (a)", what="phase 5's one-shot", bitwise_bar=False):
    """Phase 20 (a): phase 5's one-shot through the cell step on one NCCL
    rank (model 1, data 1) against the local executor's run (phase 21 (b):
    phase 16's granite-moe one-shot, ``tag`` and ``what`` its log's, and
    ``bitwise_bar`` failing unless tokens and logits are bitwise).  Returns
    the run's launches and its record."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    m = ref["cfg"].model
    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                            rank=0, world_size=1)
    try:
        run = p20_oneshot(make_host_mesh(model=1, data=1), ref)
    finally:
        dist.destroy_process_group()
    bitwise, gap, tol = p20_compare("(a)", run, ref, m)
    slot = ref["slot_dp"]
    if not np.array_equal(run["tokens"], slot.tokens):
        fail(f"{tag}: tokens differ from the local executor's")
    if not np.array_equal(run["lengths"], slot.lengths):
        fail(f"{tag}: prefill lengths differ from the local executor's")
    if bitwise_bar and not bitwise:
        fail(f"{tag}: logits not bitwise the local executor's (gap {gap})")
    p20_contract("one NCCL rank", run["collectives"], m, 1, tag)
    if run["launches"]["fairkv_decode"] != m.n_layers * GEN or \
            run["launches"]["snapkv_scores"] != m.n_layers:
        fail(f"{tag}: launches {run['launches']}")
    log(f"{tag} one NCCL rank, the cell step on {what} (fairkv_dp, "
        f"{m.n_layers} layers, B {B} x {T}, {GEN} tokens): tokens equal, lengths bitwise, "
        f"logit gap {gap:.6f} (bar {tol:.4f}); {'bitwise' if bitwise else 'not bitwise'} the "
        f"local executor's; prefill {run['prefill_s']:.2f} s, eager decode step median "
        f"{run['step_ms']:.2f} ms (local graphed "
        f"{1e3 * statistics.median(slot.step_s):.2f}); per decode step "
        f"{run['collectives']}; launches {run['launches']}")
    return run["launches"], run


def p20_gloo_rank(mesh, ref):
    """One rank of phase 20 (b)."""
    import torch
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 logs
    torch.backends.cuda.matmul.allow_tf32 = False
    return p20_oneshot(mesh, ref, memory=True)


def p20_prediction(ref):
    """Phase 20 (b)'s predicted peaks: the same steps on fake tensors on a
    fake (data 1, model ``P20_MODEL``) mesh, rank 0's (every rank's shapes
    are the same): the prefill's, then the first decode step's."""
    import torch
    from repro_torch.distributed import step_stats
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    with fake_process_group(P20_MODEL), step_stats.fake_tensors(), torch.inference_mode():
        mesh = make_production_mesh(model=P20_MODEL, data=1)
        a = p20_build(mesh, ref, init_device="cpu")
        sp, pa, batch = a["sp"], a["pa"], a["batch"]
        (state, _, _), pre = step_stats.measure(a["steps"]["prefill"], (sp, batch, pa),
                                                sp, batch, pa)
        _, dec = step_stats.measure(a["steps"]["decode"], (sp, state, pa), sp, state, pa)
    return {"prefill": pre.peak_bytes, "decode": dec.peak_bytes}


def p20_gloo_start(ref, rank_fn=None, model=P20_MODEL, data=1):
    """Phase 20 (b)'s ranks: two gloo ranks sharing the card (model
    ``P20_MODEL``, data 1, eager) run the same one-shot, spawned from a
    thread so that (a) runs meanwhile; returns ``join()``, which gives
    the ranks' results (or raises what the spawn raised).  Phase 21 passes
    its own ``rank_fn(mesh, ref)``, mesh shape and ``ref``."""
    import tempfile
    import threading

    from repro_torch.launch.mesh import spawn
    box = {}
    # the ranks rebuild the seed weights; phase 5's logits stay here
    sent = {k: ref[k] for k in ("cfg", "profile", "prompts", "teacher") if k in ref}
    sent.update(ref.get("send", {}))

    def run():
        try:
            box["ranks"] = spawn(rank_fn or p20_gloo_rank, model=model, data=data,
                                 backend="gloo",
                                 device="cuda", args=(sent,),
                                 init_file=f"{tempfile.mkdtemp()}/rendezvous", timeout=600)
        except BaseException as e:  # handed to the caller by join()
            box["error"] = e

    th = threading.Thread(target=run, daemon=True)
    th.start()

    def join():
        th.join()
        if "error" in box:
            raise box["error"]
        return box["ranks"]

    return join


def p20_gloo(ref, ranks, predicted):
    """Phase 20 (b)'s checks on the ranks' results: the plan bar, argmax
    agreement, the contract, each rank's peaks within
    `P19_PREDICTION_TOL` of the fake-tensor prediction, and the MLP's and
    vocab's bytes halved."""
    import numpy as np
    m = ref["cfg"].model
    n_v = m.padded_vocab // P20_MODEL
    run = dict(ranks[0])
    run["logits"] = np.concatenate([r["logits"] for r in ranks], axis=-1)
    problems = []  # every rank's numbers are logged before the phase fails
    for r, got in enumerate(ranks):
        if got["logits"].shape[-1] != n_v or not np.array_equal(got["tokens"], ranks[0]["tokens"]):
            problems.append(f"rank {r}: logits of {got['logits'].shape[-1]} columns (want "
                            f"{n_v}) or tokens unlike rank 0's")
        mine, whole = got["mlp_vocab_bytes"]
        if 2 * mine != whole:
            problems.append(f"rank {r}: MLP and vocab weights {mine} B, not half of {whole} B")
        gaps = {step: abs(predicted[step] - got["peak"][step]) / got["peak"][step]
                for step in ("prefill", "decode")}
        problems += [f"rank {r} {step}: predicted peak {predicted[step]} B is "
                     f"{100 * gap:.1f}% off max_memory_allocated {got['peak'][step]} B"
                     for step, gap in gaps.items() if gap > P19_PREDICTION_TOL]
        log(f"[p20] (b) rank {r}: MLP + vocab weights {mine} B (the whole tree's {whole} B); "
            + "; ".join(f"{step} peak {got['peak'][step]} B, predicted {predicted[step]} B "
                        f"({100 * gaps[step]:.2f}%)" for step in ("prefill", "decode"))
            + f"; per decode step {got['collectives']}")
    slot = ref["slot_dp"]
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(slot.logits).max())
    gap = float(np.abs(run["logits"] - slot.logits).max())
    agree = float((run["tokens"] == slot.tokens).mean())
    same_len = bool(np.array_equal(run["lengths"], slot.lengths))
    log(f"[p20] (b) two gloo ranks (model {P20_MODEL}): logit gap {gap:.4f} (bar {tol:.4f}); "
        f"argmax equal to the local run at {100 * agree:.1f}% of positions; prefill lengths "
        f"{'bitwise' if same_len else 'not bitwise'} the local's (the MLP's partial sums round "
        f"apart in bf16; reported, not a bar); prefill {run['prefill_s']:.2f} s, decode step "
        f"median {run['step_ms']:.2f} ms; rank 0 launches {run['launches']}")
    if problems:
        fail("[p20] (b) " + "; ".join(problems))
    for r, got in enumerate(ranks):
        p20_contract(f"(b) rank {r}", got["collectives"], m, P20_MODEL)
    p20_compare("(b)", run, ref, m)
    return run["launches"]


P20_DENSE = ("minitron-8b", "gemma2-9b", "granite-3-2b", "qwen1.5-110b")


def p20_sweep(records):
    """Phase 20 (c): phase 19 (c)'s decode_32k records of the dense archs,
    which executed the cell step: args, peak and collectives; fails unless
    each ran to the end, held the contract, and qwen1.5-110b's fits."""
    by_arch = {r["arch"]: r for r in records}
    for arch in P20_DENSE:
        rec = by_arch.get(arch, {})
        ex = rec.get("executed")
        if rec.get("status") != "ok" or ex is None:
            fail(f"[p20] (c) {arch} decode_32k did not execute its step: {rec.get('status')}")
        if not all(ex["contract"].values()):
            fail(f"[p20] (c) {arch}: decode contract {ex['contract']}")
        g = ex["collectives_by_group"]
        log(f"[p20] (c) {arch} decode_32k on (data 16, model 16), {ex['step']}: args "
            f"{ex['memory']['argument_bytes']} B, peak {ex['memory']['peak_bytes']} B, fits "
            f"{rec['fits']} ({rec['device_bytes']} B); collectives {g}")
    if not by_arch["qwen1.5-110b"]["fits"]:
        fail("[p20] (c) qwen1.5-110b's decode_32k cell does not fit the card")


def p20_runs(ref, records):
    """Phase 20: the serve cells' step on the card, (a) while (b)'s ranks
    run (the card holds both); prints the seconds and the launches (apart
    from the kernel table)."""
    t0 = time.perf_counter()
    # the prediction's fake process group and (a)'s NCCL one are this
    # process's default group in turn, so the prediction goes first
    predicted = p20_prediction(ref)
    join = p20_gloo_start(ref)
    t1 = time.perf_counter()
    a, _ = p20_nccl(ref)
    t2 = time.perf_counter()
    b = p20_gloo(ref, join(), predicted)
    p20_sweep(records)
    log(f"[p20] phase 20 took {time.perf_counter() - t0:.1f} s (prediction {t1 - t0:.1f} s, "
        f"(a) {t2 - t1:.1f} s beside (b)'s ranks); launches (a) {a}, (b) rank 0 {b}")


# ---------------------------------------------------------------------------
# phase 21: long_500k's split-S decode and the MoE cells' expert parallelism
# ---------------------------------------------------------------------------

# (a) gemma2-9b at full width cut to 4 of 42 layers (0 and 2 local, window
# 4096; 1 and 3 global), B 1, policy none at capacity 131,072 (+ the
# 64-column ring): the cell's 524,288 cut so that the local executor's
# whole cache fits on the card beside the ranks' shards
P21_LAYERS = 4
P21_CAP = 131_072
P21_LEN_MIN = 100_000  # per-(slot, row) lengths from here to the capacity
P21_STEPS = 16
P21_DATA = 2  # (a)'s gloo ranks: the columns split over data
P21_PEAK_TOL = 0.05  # the ranks' peaks within 5% of the fake prediction
P21_C_LOC = 65_536  # the partial kernel's timed shard
# a long_500k cell as phases 21 (a) and 22 (c) run it: the arch cut to
# ``layers``, B 1, policy none at capacity ``cap`` (+ the ring), lengths
# drawn in [len_min, cap], ``steps`` decode steps, the gloo ranks' ``data``
P21_CELL = dict(arch="gemma2-9b", layers=P21_LAYERS, cap=P21_CAP, len_min=P21_LEN_MIN,
                steps=P21_STEPS, data=P21_DATA, tag="[p21] (a)")


def p21_long_setup(cell=P21_CELL):
    """(model config, compression, plan) of a long cell: the cell's plan rule
    (`specs.cell_plan`, 8 shards, B 1; None when attention-free)."""
    from repro_torch.compression.base import CompressionConfig
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    m = get_config(cell["arch"]).with_overrides(n_layers=cell["layers"])
    ccfg = CompressionConfig(policy="none", budget=cell["cap"], capacity=cell["cap"],
                             decode_margin=MARGIN)
    return m, ccfg, specs.cell_plan(m, N_SHARDS, batch_cap=1)


def p21_long_state(m, plan, ccfg, device, cols, fill=True, cell=P21_CELL):
    """A long cell's decode state as the cell's tree, its columns ``cols``
    (start, stop) of every (slot, row): from seed 0, owned pairs hold
    lengths in [``len_min``, ``cap``] and each layer's first owned slot is
    at the static capacity (its first append wraps the ring); entry c sits
    at position c, the row at position C; unowned pairs are empty.  The K /
    V of each (layer, slot) come from a generator of their own over all C
    columns, so every rank builds its columns of one cache.  A model with
    an SSD branch also gets a seed-0 SSD state and conv window (whole: the
    long cell's gloo ranks split over data only); an attention-free one has
    no cache.  ``fill=False`` leaves them uninitialised (fake tensors)."""
    import torch
    from repro_torch.cache.slot_cache import PlanArrays
    L, Dh = m.n_layers, m.head_dim
    C = ccfg.static_capacity()
    c0, c1 = cols
    dev = torch.device(device)
    if fill:
        g = torch.Generator(device=dev)
        g.manual_seed(SEED)
    out = {"last_tokens": torch.ones((1,), dtype=torch.int64, device=dev), "decode_steps": 0}
    if m.family in ("ssm", "hybrid"):
        sc = m.ssm
        ss = torch.empty((L, 1, sc.num_heads, sc.head_dim, sc.state_size), device=dev)
        cs = torch.empty((L, 1, sc.conv_width - 1, sc.d_inner + 2 * sc.n_groups * sc.state_size),
                         dtype=torch.bfloat16, device=dev)
        if fill:
            ss.copy_(0.1 * torch.randn(ss.shape, generator=g, device=dev))
            cs.copy_(torch.randn(cs.shape, generator=g, device=dev))
        out.update(ssm_state=ss, conv_state=cs)
    if plan is None:
        return out
    S = plan.n_slots
    k = torch.empty((L, S, 1, c1 - c0, Dh), dtype=torch.bfloat16, device=dev)
    v = torch.empty_like(k)
    lengths = torch.empty((L, S, 1), dtype=torch.int32, device=dev)
    pos = torch.empty((L, S, 1, c1 - c0), dtype=torch.int32, device=dev)
    if fill:
        own = PlanArrays.from_plan(plan, device=dev).owner_mask_all(1)  # (L, S, 1)
        ln = torch.randint(cell["len_min"], cell["cap"] + 1, (L, S, 1), generator=g, device=dev)
        first = own[:, :, 0].to(torch.int32).argmax(dim=1)
        ln[torch.arange(L, device=dev), first, 0] = C
        lengths.copy_(torch.where(own, ln, 0))
        cols_ix = torch.arange(c0, c1, dtype=torch.int32, device=dev)
        pos.copy_(torch.where(cols_ix < lengths[..., None], cols_ix, -1))
        for i in range(L):
            for j in range(S):
                for t, off in ((k, 0), (v, 1)):
                    g.manual_seed(SEED + 1 + 2 * (i * S + j) + off)
                    full = torch.randn((C, Dh), generator=g, device=dev, dtype=torch.bfloat16)
                    t[i, j, 0].copy_(full[c0:c1])
                    del full
    out["cache"] = {"k": k, "v": v, "lengths": lengths, "pos": pos,
                    "positions": torch.full((1,), C, dtype=torch.int32, device=dev)}
    return out


def _p21_written(cache, c0, C):
    """The cache entries this run wrote (position >= C, the row's position
    at the start): (keys (n, 3) of layer, slot, global column; k, v, pos)
    as numpy, sorted by key."""
    import numpy as np
    import torch
    at = torch.nonzero(cache.pos[:, :, 0] >= C)  # (n, 3): layer, slot, local column
    li, si, ci = at.unbind(1)
    key = torch.stack([li, si, ci + c0], dim=1).cpu().numpy()
    vals = [cache.k[li, si, 0, ci].float().cpu().numpy(),
            cache.v[li, si, 0, ci].float().cpu().numpy(), cache.pos[li, si, 0, ci].cpu().numpy()]
    order = np.lexsort(key.T[::-1])
    return key[order], [x[order] for x in vals]


def p21_long_build(mesh, init_device=None, fill=True, cell=P21_CELL):
    """A long cell's step on ``mesh``'s rank under ``serve_rules(long_context=
    True)``: the rank's shards of the seed weights and plan arrays, its
    columns of the state (`p21_long_state`) and the decode step."""
    import dataclasses

    import torch
    from repro_torch.cache.slot_cache import PlanArrays
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import serve_rules, split
    from repro_torch.launch import specs
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as S
    m, ccfg, plan = p21_long_setup(cell)
    rules = serve_rules(mesh, long_context=True)
    dev = init_device or mesh.device
    sp = S.slotify_params(init_params(m, SEED, torch.bfloat16, device=dev), plan, m)
    sp_spec = tree_specs(sp, rules, "serve")
    sp = local_shard(sp, sp_spec, mesh)
    pa = None
    if plan is not None:
        pa = PlanArrays.from_plan(plan, device=dev)
        pa = local_shard({f.name: getattr(pa, f.name) for f in dataclasses.fields(pa)},
                         specs.plan_specs(plan, rules), mesh)
    C = ccfg.static_capacity()
    sc = split(rules, mesh, "cache_len", C)
    n_loc = C // sc.size
    cols = (sc.offset(n_loc), sc.offset(n_loc) + n_loc)
    state = p21_long_state(m, plan, ccfg, mesh.device, cols, fill, cell)
    if init_device is not None:  # fake tensors built on the host: to the mesh's device
        sp, pa = (specs._to_device(x, mesh.device) for x in (sp, pa))
    step = specs.serve_step("decode", m, ccfg, mesh, rules, sp_spec,
                            0 if plan is None else plan.n_slots, 1)
    return {"sp": sp, "pa": pa, "state": state, "step": step, "cols": cols, "C": C}


def p21_long_steps(mesh, teacher, memory=False, cell=P21_CELL):
    """A long cell through the cell step on ``mesh``'s rank: its ``steps``
    decode steps fed ``teacher`` (the local executor's tokens).  Returns
    the tokens, logits, lengths, the entries written, the final SSD / conv
    state, one step's collectives, the launches, the median step ms and,
    with ``memory``, the first step's ``max_memory_allocated`` above the
    memory allocated before its arguments."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.distributed import comm
    from repro_torch.kernels import build
    base = torch.cuda.memory_allocated() if memory else 0
    a = p21_long_build(mesh, cell=cell)
    sp, pa, step = a["sp"], a["pa"], a["step"]
    state = a["state"]
    teacher = torch.as_tensor(teacher, dtype=torch.int64, device=mesh.device)
    out, toks, logit_rows, step_s = {}, [], [], []
    build.reset_launches()
    with torch.inference_mode():
        for t in range(cell["steps"]):
            if t:
                state = dataclasses.replace(state, last_tokens=teacher[t - 1:t])
            if t == 0:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            before = comm.snapshot()
            t0 = time.perf_counter()
            state, lg = step(sp, state, pa)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            if t == 0:
                out["peak"] = torch.cuda.max_memory_allocated() - base
                out["collectives"] = comm.by_kind(comm.since(before))
            toks.append(int(state.last_tokens[0]))
            logit_rows.append(lg[0].float().cpu().numpy())
    cache = state.cache
    out.update(tokens=np.array(toks), logits=np.stack(logit_rows),
               lengths=None if cache is None else cache.lengths.cpu().numpy(),
               written=None if cache is None else _p21_written(cache, a["cols"][0], a["C"]),
               launches=dict(build.LAUNCHES), step_ms=1e3 * statistics.median(step_s),
               cols=a["cols"], state=_p22_states(state))
    return out


def p21_long_local(cell=P21_CELL):
    """A long cell's reference: the local executor's decode steps (graphed)
    on the whole state, free-running from token 1 (an attention-free model:
    the engine's one-slot plan).  Returns its tokens, logits, lengths,
    written entries, final SSD / conv state, launches, the final cache and
    plan arrays (for the kernel checks)."""
    import numpy as np
    import torch
    from repro_torch.cache.slot_cache import PlanArrays, SlotCache
    from repro_torch.core.planner import PlannerConfig, build_plan
    from repro_torch.exec.local import LocalExecutor
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as S
    m, ccfg, plan = p21_long_setup(cell)
    C = ccfg.static_capacity()
    sp = S.slotify_params(init_params(m, SEED, torch.bfloat16, device="cuda"), plan, m)
    if plan is None:  # the engine's plan of an attention-free model: one slot
        plan = build_plan(np.ones((m.n_layers, 1)), 1, PlannerConfig(mode="sha",
                                                                      slots_per_shard=1))
    pa = PlanArrays.from_plan(plan, device="cuda")
    st = p21_long_state(m, None if m.attention_free else plan, ccfg, "cuda", (0, C), cell=cell)
    cache = SlotCache(**st.pop("cache")) if "cache" in st else None
    state = S.ServeState(cache=cache, **st)
    ex = LocalExecutor(m, ccfg, device="cuda")
    toks, logit_rows = [], []
    build.reset_launches()
    with torch.inference_mode():
        for _ in range(cell["steps"]):
            state, lg = ex.decode(sp, state, pa)
            toks.append(int(state.last_tokens[0]))
            logit_rows.append(lg[0].float().cpu().numpy())
    cache = state.cache
    return {"tokens": np.array(toks), "logits": np.stack(logit_rows),
            "lengths": None if cache is None else cache.lengths.cpu().numpy(),
            "written": None if cache is None else _p21_written(cache, 0, C),
            "launches": dict(build.LAUNCHES), "state": _p22_states(state),
            "cache": cache, "n_layers": m.n_layers, "C": C}


def _cublas_workspace(device) -> None:
    """One product in each dtype the steps use, so that the process's cuBLAS
    workspace (allocated at its first product, 32 MiB on this card) exists
    before a step's memory is measured against the fake prediction, which
    counts the step's tensors only."""
    import torch
    for dt in (torch.bfloat16, torch.float32):
        x = torch.ones((8, 64), dtype=dt, device=device)
        x @ x.T
    torch.cuda.synchronize()


def p21_long_rank(mesh, args):
    """One gloo rank of a long cell: the cell step on its columns."""
    import torch
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 logs
    torch.backends.cuda.matmul.allow_tf32 = False
    _cublas_workspace(mesh.device)
    out = p21_long_steps(mesh, args["teacher"], memory=True, cell=args.get("cell", P21_CELL))
    out["state"] = {k: v.float().numpy() for k, v in out["state"].items()}
    return out


def p21_long_prediction(cell=P21_CELL):
    """A long cell's gloo ranks' peak, predicted on fake tensors on a fake
    (data ``data``, model 1) mesh: rank 0's first decode step."""
    import torch
    from repro_torch.distributed import step_stats
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    with fake_process_group(cell["data"]), step_stats.fake_tensors(), torch.inference_mode():
        mesh = make_production_mesh(model=1, data=cell["data"])
        a = p21_long_build(mesh, init_device="cpu", fill=False, cell=cell)
        _, st = step_stats.measure(a["step"], (a["sp"], a["state"], a["pa"]), a["sp"],
                                   a["state"], a["pa"])
    return st.peak_bytes


def _p21_same_written(name, got, want, bitwise=True, tag="[p21] (a)", n_layers=P21_LAYERS):
    """The entries a run wrote against the local executor's: the same
    (layer, slot, column) keys and positions, and K / V bitwise; without
    ``bitwise`` (split-S) only layer 0's K / V are bitwise (they come from
    the fed token alone) and later layers' are within n_layers 2^-8
    max|entry| (their inputs passed through the merged attention, whose
    fp32 sums add in another order).  Returns the largest K / V gap."""
    import numpy as np
    (gk, gv), (wk, wv) = got, want
    if not (np.array_equal(gk, wk) and np.array_equal(gv[2], wv[2])):
        fail(f"{tag} {name}: the written entries' places or positions differ from the local "
             f"executor's ({len(gk)} against {len(wk)} entries)")
    first = wk[:, 0] == 0
    gap = max(float(np.abs(a - b).max()) for a, b in zip(gv[:2], wv[:2]))
    bar = n_layers * 2.0 ** -8 * max(float(np.abs(b).max()) for b in wv[:2])
    exact = all(np.array_equal(a[first if not bitwise else slice(None)],
                               b[first if not bitwise else slice(None)])
                for a, b in zip(gv[:2], wv[:2]))
    if not exact or gap > (0.0 if bitwise else bar):
        fail(f"{tag} {name}: written K / V differ from the local executor's: gap {gap} "
             f"(bar {0.0 if bitwise else bar}; layer 0 bitwise {exact})")
    return gap


def p21_long_check(name, run, ref, data, tag="[p21] (a)", cell=P21_CELL):
    """Bars of a run of a long cell against the local executor's: tokens
    equal, lengths bitwise, the logit gap under n_layers 2^-8 max|logit|,
    the contract (`dryrun.decode_contract`: for gemma2 2·L + 1 all-reduces
    over model, the pair gather, L split-S gathers over data when ``data``
    > 1).  Returns (gap, bar, bitwise)."""
    import numpy as np
    from repro_torch.configs import get_config
    from repro_torch.launch import dryrun
    m = get_config(cell["arch"]).with_overrides(n_layers=cell["layers"])
    if not np.array_equal(run["tokens"], ref["tokens"]):
        fail(f"{tag} {name}: tokens {run['tokens'].tolist()} differ from the local "
             f"executor's {ref['tokens'].tolist()}")
    if not np.array_equal(run["lengths"], ref["lengths"]):
        fail(f"{tag} {name}: lengths differ from the local executor's")
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(ref["logits"]).max())
    gap = float(np.abs(run["logits"] - ref["logits"]).max())
    if not (np.isfinite(run["logits"]).all() and gap < tol):
        fail(f"{tag} {name}: logit gap {gap} >= {tol} (or not finite)")
    got = dryrun.decode_contract(run["collectives"], m, 1, 1, data, split_s=True)
    if not all(got.values()):
        fail(f"{tag} {name}: collectives {run['collectives']} break the contract {got}")
    return gap, tol, bool(np.array_equal(run["logits"], ref["logits"]))


def _partial_times(args, kw, flush, tag):
    """Kernel 1's partial variant on one shard (``args`` = (q, k, v, lengths,
    softcap), ``kw`` its positions and window): its device ms, its plain
    version's, the efficient SDPA's with log-sum-exp (None where this
    build has no such call), the bound (the retained entries' K / V, q and
    the fp32 (o, lse) moved once at 3.35 TB/s, or 4·n·G·Dh operations at
    989 TFLOP/s, whichever is larger), what binds it, its bytes and the
    retained entries."""
    import torch
    from repro_torch.kernels.fairkv_decode import fairkv_decode_partial_cuda
    from repro_torch.kernels.ref import fairkv_decode_partial_ref
    q, k, v, ln, _ = args
    S, G, Dh = q.shape[1], q.shape[2], q.shape[3]
    c_loc = k.shape[2]
    kern = time_ms(lambda: fairkv_decode_partial_cuda(*args, **kw), flush)
    plain = time_ms(lambda: fairkv_decode_partial_ref(*args, **kw), flush)
    it = k.element_size()
    n_ret = int(ln.sum().item())
    nbytes = n_ret * Dh * 2 * it + q.numel() * it + q.numel() * 4 + S * G * 4 + ln.numel() * 4
    flops = 4 * n_ret * G * Dh
    bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S)
    lib = None
    try:  # one PyTorch call with the same (o, lse): the efficient SDPA, length-masked
        qs = q.permute(1, 0, 2, 3).reshape(S, G, 1, Dh)
        ks = k.reshape(S, 1, c_loc, Dh).expand(S, G, c_loc, Dh)
        vs = v.reshape(S, 1, c_loc, Dh).expand(S, G, c_loc, Dh)
        mask = torch.arange(c_loc, device="cuda")[None, :] < ln.reshape(-1, 1)
        bias = torch.where(mask, 0.0, float("-inf")).to(q.dtype)[:, None, None, :].expand(
            S, G, 1, c_loc)
        sdpa = torch.ops.aten._scaled_dot_product_efficient_attention

        def call():
            return sdpa(qs, ks, vs, bias, True)
        call()
        lib = time_ms(call, flush)
    except Exception as e:  # noqa: BLE001 - no such call on this build: reported
        log(f"{tag} the efficient SDPA with log-sum-exp did not run here ({type(e).__name__}: "
            f"{e}); the partial kernel's library_ms is null")
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations"
    return kern, plain, lib, bound, bound_by, nbytes, n_ret


def p21_kernel_rows(ref, rows, launches):
    """The partial kernel against its plain version on (a)'s final cache
    (Dh 256, G 2, B 1): the global layer 1 on columns [C_loc, 2 C_loc), the
    window layer 0 on [0, C_loc) (every entry outside the window: empty
    shards) and on [C_loc, 2 C_loc); o and lse within FP32_TOL + 1e-5|plain|,
    the empty pairs' o = 0 and lse = -inf exactly.  Timed on the global
    layer's shard (C_loc = 65,536) beside its bound, its plain version and
    the efficient SDPA with log-sum-exp; kernel 1 timed at (B 1, C
    131,136) on the whole global layer and on the whole window layer 0
    (``*_long_b1_window``: the window keeps the last 4096 positions).  Adds
    the partial kernel's row to ``rows`` and kernel 1's long-context times
    to its row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.cache.slot_cache import shard_lengths
    from repro_torch.kernels.fairkv_decode import fairkv_decode_cuda, fairkv_decode_partial_cuda
    from repro_torch.kernels.ref import fairkv_decode_partial_ref, fairkv_decode_ref
    from repro_torch.models.transformer import layer_window
    from repro_torch.configs import get_config
    m = get_config("gemma2-9b").with_overrides(n_layers=P21_LAYERS)
    cache, C = ref["cache"], ref["C"]
    S, G, Dh = cache.k.shape[1], m.q_per_kv, m.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 21)
    q = torch.randn((1, S, G, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    qpos = cache.positions
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    err = 0.0
    cases = {}
    for layer, c0 in ((1, P21_C_LOC), (0, 0), (0, P21_C_LOC)):
        cols = slice(c0, c0 + P21_C_LOC)
        k, v, kp = (t[layer, :, :, cols].contiguous() for t in (cache.k, cache.v, cache.pos))
        ln = shard_lengths(cache.lengths[layer], c0, P21_C_LOC)
        window = layer_window(m, layer)
        args = (q, k, v, ln, m.attn_softcap)
        kw = dict(k_pos=kp, q_pos=qpos, window=window)
        o, lse = fairkv_decode_partial_cuda(*args, **kw)
        o_ref, lse_ref = fairkv_decode_partial_ref(*args, **kw)
        torch.cuda.synchronize()
        empty = torch.isinf(lse_ref)
        if not (torch.equal(torch.isinf(lse), empty) and bool((o[empty] == 0).all())):
            fail(f"[p21] partial kernel (layer {layer}, columns {c0}+): empty pairs not "
                 f"o = 0, lse = -inf")
        live = ~empty
        tag = f"fairkv_decode_partial (layer {layer}, window {window}, columns {c0}+)"
        err = max(err, _cmp(tag, o, o_ref, FP32_TOL, 1e-5),
                  _cmp(tag + " lse", torch.where(live, lse, 0.0),
                       torch.where(live, lse_ref, 0.0), FP32_TOL, 1e-5))
        cases[(layer, c0)] = (args, kw, int(empty.sum()), int(live.sum()))
    log(f"[p21] partial kernel on (a)'s cache (B 1, S {S}, G {G}, Dh {Dh}, C_loc "
        f"{P21_C_LOC}): o and lse within {FP32_TOL:g} + 1e-5|plain| of the plain version "
        f"(max err {err:.3e}); empty / live (slot, head) pairs per case "
        f"{ {k: (e, l) for k, (_, _, e, l) in cases.items()} }")
    args, kw, _, _ = cases[(1, P21_C_LOC)]
    kern, plain, lib, bound, bound_by, nbytes, n_ret = _partial_times(args, kw, flush, "[p21]")
    rows.append({"name": "fairkv_decode_partial", "route": "cuda",
                 "source": "src/repro_torch/csrc/fairkv_decode.cu",
                 "replaces": "src/repro/kernels/fairkv_decode.py:107",
                 "launches": launches, "max_abs_err": err, "ms": kern, "plain_ms": plain,
                 "bound_ms": bound, "bound_by": bound_by, "library_ms": lib})
    it = cache.k.element_size()
    # kernel 1 on the whole global layer at long context
    k1, v1, p1 = cache.k[1], cache.v[1], cache.pos[1]
    ln1 = cache.lengths[1]
    k1_ms = time_ms(lambda: fairkv_decode_cuda(q, k1, v1, ln1, m.attn_softcap), flush)
    k1_ref = fairkv_decode_ref(q, k1, v1, ln1, m.attn_softcap)
    _cmp("fairkv_decode (B 1, long context)", fairkv_decode_cuda(q, k1, v1, ln1, m.attn_softcap),
         k1_ref, FP32_TOL, BF16_ULP)
    n1 = int(ln1.sum().item())
    b1 = n1 * Dh * 2 * it + 2 * q.numel() * it + ln1.numel() * 4
    k1_bound = 1e3 * max(b1 / HBM_BYTES_PER_S, 4 * n1 * G * Dh / BF16_FLOP_PER_S)
    k1_lib = sdpa_decode_ms(q, k1, v1, ln1, flush)
    # and on the whole window layer 0: the window keeps the last 4096
    # positions, so the bytes this data needs are every retained entry's
    # position and the kept entries' K / V
    k0, v0, p0, ln0 = cache.k[0], cache.v[0], cache.pos[0], cache.lengths[0]
    w0 = layer_window(m, 0)
    kw0 = dict(k_pos=p0, q_pos=qpos, window=w0)
    err0 = _cmp("fairkv_decode (B 1, long context, window layer)",
                fairkv_decode_cuda(q, k0, v0, ln0, m.attn_softcap, **kw0),
                fairkv_decode_ref(q, k0, v0, ln0, m.attn_softcap, **kw0), FP32_TOL, BF16_ULP)
    w_ms = time_ms(lambda: fairkv_decode_cuda(q, k0, v0, ln0, m.attn_softcap, **kw0), flush)
    n0 = int(ln0.sum().item())
    kept = int(((torch.arange(k0.shape[2], device="cuda") < ln0[..., None])
                & (p0 > qpos[0] - w0)).sum().item())
    b0 = kept * Dh * 2 * it + n0 * 4 + 2 * q.numel() * it + ln0.numel() * 4
    w_bound = 1e3 * max(b0 / HBM_BYTES_PER_S, 4 * kept * G * Dh / BF16_FLOP_PER_S)
    w_lib = sdpa_decode_ms(q, k0, v0, ln0, flush, p0, qpos, w0)
    for row in rows:
        if row["name"] == "fairkv_decode":
            row.update(ms_long_b1=k1_ms, bound_ms_long_b1=k1_bound, library_ms_long_b1=k1_lib,
                       ms_long_b1_window=w_ms, bound_ms_long_b1_window=w_bound,
                       library_ms_long_b1_window=w_lib, max_abs_err_long_b1_window=err0)
    log(f"[time] fairkv_decode_partial at (B 1, S {S}, G {G}, C_loc {P21_C_LOC}, Dh {Dh}) "
        f"bf16, sum(lengths) = {n_ret}: kernel {kern:.4f} ms, plain {plain:.4f} ms, "
        f"efficient SDPA {lib if lib is None else f'{lib:.4f}'} ms, bound {bound:.4f} ms "
        f"({nbytes} B); kernel 1 at (B 1, S {S}, C {C}): {k1_ms:.4f} ms, SDPA {k1_lib:.4f} "
        f"ms (no softcap), bound {k1_bound:.4f} ms (sum(lengths) = {n1}); on the window "
        f"layer (window {w0}, {kept} of {n0} entries kept): {w_ms:.4f} ms, SDPA {w_lib:.4f} "
        f"ms, bound {w_bound:.4f} ms ({b0} B)")


def p21_long(rows):
    """Phase 21 (a): the local executor, then the cell step on one NCCL
    rank (data 1) while two gloo ranks (data ``P21_DATA``) share the card;
    the partial kernel's checks and times on the local run's cache."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    predicted = p21_long_prediction()
    ref = p21_long_local()
    L = ref["n_layers"]
    if ref["launches"]["fairkv_decode"] != L * P21_STEPS:
        fail(f"[p21] (a) local executor launches {ref['launches']}")
    wrapped = int((ref["written"][0][:, 2] >= ref["C"] - MARGIN).sum())
    if not wrapped:
        fail("[p21] (a) no append landed in the recency ring: nothing wrapped")
    join = p20_gloo_start({"send": {"teacher": ref["tokens"]}}, rank_fn=p21_long_rank,
                          model=1, data=P21_DATA)
    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                            rank=0, world_size=1)
    try:
        one = p21_long_steps(make_host_mesh(model=1, data=1), ref["tokens"])
    finally:
        dist.destroy_process_group()
    gap, tol, bitwise = p21_long_check("one NCCL rank", one, ref, 1)
    _p21_same_written("one NCCL rank", one["written"], ref["written"])
    if not bitwise or one["launches"]["fairkv_decode"] != L * P21_STEPS \
            or one["launches"]["fairkv_decode_partial"]:
        fail(f"[p21] (a) one NCCL rank: logits bitwise {bitwise}, launches {one['launches']} "
             f"(want {L * P21_STEPS} of kernel 1, none of the partial variant)")
    log(f"[p21] (a) one NCCL rank (data 1), gemma2-9b {L} layers, B 1, C {ref['C']}, "
        f"{P21_STEPS} steps: tokens, lengths, logits and {len(one['written'][0])} written "
        f"entries ({wrapped} in the ring) bitwise the local executor's; eager step median "
        f"{one['step_ms']:.2f} ms; per step {one['collectives']}; launches {one['launches']}")
    ranks = join()
    problems = []
    for r, got in enumerate(ranks):
        gap_r, tol_r, _ = p21_long_check(f"gloo rank {r}", got, ref, P21_DATA)
        if got["launches"]["fairkv_decode_partial"] != L * P21_STEPS or \
                got["launches"]["fairkv_decode"]:
            problems.append(f"rank {r}: launches {got['launches']}")
        off = abs(predicted - got["peak"]) / got["peak"]
        if off > P21_PEAK_TOL:
            problems.append(f"rank {r}: peak {got['peak']} B, predicted {predicted} B "
                            f"({100 * off:.1f}% off)")
        log(f"[p21] (a) gloo rank {r} (data {P21_DATA}, columns {got['cols']}): tokens equal, "
            f"lengths bitwise, logit gap {gap_r:.5f} (bar {tol_r:.4f}); first step peak "
            f"{got['peak']} B, predicted {predicted} B ({100 * off:.2f}%); eager step median "
            f"{got['step_ms']:.2f} ms; per step {got['collectives']}; launches "
            f"{got['launches']}")
    keys = np.concatenate([g["written"][0] for g in ranks])
    vals = [np.concatenate([g["written"][1][i] for g in ranks]) for i in range(3)]
    order = np.lexsort(keys.T[::-1])
    kv_gap = _p21_same_written("gloo ranks", (keys[order], [x[order] for x in vals]),
                               ref["written"], bitwise=False)
    if problems:
        fail("[p21] (a) " + "; ".join(problems))
    p21_kernel_rows(ref, rows, ranks[0]["launches"]["fairkv_decode_partial"])
    ref = None
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[p21] (a) took {time.perf_counter() - t0:.1f} s; the gloo ranks' written entries: "
        f"places, positions and layer 0's K / V bitwise the local executor's, later layers' "
        f"K / V within {kv_gap:.5f}")
    return ranks[0]["launches"]


def _p21_drop_spy(m, n_calls, T_global):
    """Wrap `repro_torch.models.moe.route` (both MoE blocks call it by name)
    to record, for its first ``n_calls`` calls (the prefill's layers), the
    replicas the reference's capacity drops: Σ_e max(0, count_e - Ce) over
    the call's picks with ``Ce`` from ``T_global`` tokens (the rows are
    whole: data 1).  Returns (the list it fills, an undo callable)."""
    import torch
    from repro_torch.models import moe
    orig, drops = moe.route, []
    ce = moe.expert_capacity(T_global, m)

    def spy(x, router, top_k):
        out = orig(x, router, top_k)
        if len(drops) < n_calls:
            counts = torch.bincount(out[2].reshape(-1), minlength=m.moe.num_experts)
            drops.append(int(torch.clamp(counts - ce, min=0).sum()))
        return out

    moe.route = spy
    return drops, lambda: setattr(moe, "route", orig)


def p21_moe_rank(mesh, ref):
    """One gloo rank of (b): phase 16's granite-moe one-shot through the
    cell step, its prefill's drops recorded."""
    import torch
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")
    torch.backends.cuda.matmul.allow_tf32 = False
    m = ref["cfg"].model
    drops, undo = _p21_drop_spy(m, m.n_layers, B * T)
    try:
        out = p20_oneshot(mesh, ref, memory=True)
    finally:
        undo()
    out["drops"] = drops
    return out


def p21_moe_local_drops(ref):
    """The local executor's prefill (eager, as it runs it) of (b)'s
    one-shot, its drops per layer."""
    import torch
    from repro_torch.cache.slot_cache import PlanArrays
    from repro_torch.core.planner import build_plan
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import engine as S
    cfg = ref["cfg"]
    m = cfg.model
    plan = build_plan(ref["profile"], cfg.n_shards, cfg.planner)
    sp = S.slotify_params(init_params(m, cfg.seed, torch.bfloat16, device="cuda"), plan, m)
    pa = PlanArrays.from_plan(plan, device="cuda")
    batch = {"tokens": torch.as_tensor(ref["prompts"], dtype=torch.int64, device="cuda")}
    drops, undo = _p21_drop_spy(m, m.n_layers, B * T)
    try:
        with torch.inference_mode():
            S.prefill(sp, batch, m, pa, cfg.compression)
    finally:
        undo()
    del sp
    gc.collect()
    torch.cuda.empty_cache()
    return drops


def p21_moe(ref):
    """Phase 21 (b): phase 16's granite-moe one-shot (full width and
    depth, fairkv_dp, B 8 x 2048, 32 tokens fed its teacher tokens) through
    the cell step: one NCCL rank bitwise the local executor, two gloo
    ranks (model 2, 16 experts a rank) with the contract, peaks within 5%
    of the fake prediction, and the logit gap and argmax agreement beside
    phase 16's plan-to-plan ones; the prefill's dropped replicas per layer
    on each side."""
    import numpy as np
    t0 = time.perf_counter()
    m = ref["cfg"].model
    local_drops = p21_moe_local_drops(ref)
    predicted = p20_prediction(ref)
    join = p20_gloo_start(ref, rank_fn=p21_moe_rank)
    drops, undo = _p21_drop_spy(m, m.n_layers, B * T)
    try:
        a, _ = p20_nccl(ref, "[p21] (b)", "phase 16's granite-moe one-shot", bitwise_bar=True)
    finally:
        undo()
    if drops != local_drops:
        fail(f"[p21] (b) one NCCL rank's dropped replicas per layer {drops} differ from the "
             f"local executor's {local_drops}")
    ranks = join()
    n_v = m.padded_vocab // P20_MODEL
    run = dict(ranks[0])
    run["logits"] = np.concatenate([r["logits"] for r in ranks], axis=-1)
    problems = []
    for r, got in enumerate(ranks):
        if got["logits"].shape[-1] != n_v or not np.array_equal(got["tokens"],
                                                                ranks[0]["tokens"]):
            problems.append(f"rank {r}: logits of {got['logits'].shape[-1]} columns or tokens "
                            f"unlike rank 0's")
        mine, whole = got["mlp_vocab_bytes"]
        if 2 * mine != whole:
            problems.append(f"rank {r}: expert, router and vocab weights {mine} B, not half "
                            f"of {whole} B")
        gaps = {step: abs(predicted[step] - got["peak"][step]) / got["peak"][step]
                for step in ("prefill", "decode")}
        problems += [f"rank {r} {step}: predicted peak {predicted[step]} B is "
                     f"{100 * g:.1f}% off {got['peak'][step]} B"
                     for step, g in gaps.items() if g > P21_PEAK_TOL]
        log(f"[p21] (b) gloo rank {r}: expert, router and vocab weights {mine} B of {whole} B; "
            + "; ".join(f"{step} peak {got['peak'][step]} B, predicted {predicted[step]} B "
                        f"({100 * gaps[step]:.2f}%)" for step in ("prefill", "decode"))
            + f"; per decode step {got['collectives']}; prefill drops per layer "
            f"{got['drops']}")
        p20_contract(f"rank {r}", got["collectives"], m, P20_MODEL, "[p21] (b)")
    slot = ref["slot_dp"]
    gap = float(np.abs(run["logits"] - slot.logits).max())
    agree = float((run["logits"].argmax(-1) == slot.logits.argmax(-1)).mean())
    if not np.isfinite(run["logits"]).all():
        problems.append("the ranks' logits are not finite")
    log(f"[p21] (b) two gloo ranks (model {P20_MODEL}): logit gap {gap:.4f} and argmax "
        f"agreement {100 * agree:.1f}% against the local executor, beside phase 16's "
        f"plan-to-plan gap {ref['plan_gap']:.4f} and agreement "
        f"{100 * ref['plan_argmax']:.1f}% (reported, not a bar: bf16 rounding flips "
        f"near-tied expert picks); prefill drops per layer: local {local_drops}, NCCL "
        f"rank {drops}, gloo rank 0 {ranks[0]['drops']} "
        f"({'equal' if ranks[0]['drops'] == local_drops else 'not equal'}); prefill "
        f"{run['prefill_s']:.2f} s, decode step median {run['step_ms']:.2f} ms")
    if problems:
        fail("[p21] (b) " + "; ".join(problems))
    log(f"[p21] (b) took {time.perf_counter() - t0:.1f} s")
    return a, ranks[0]["launches"]


# (c): the cells this slice adds to the dry run; the MoE decode cells come
# from phase 19 (c)'s sweep, the others from a subprocess started before
# phase 20 (fake prefills of 32k tokens take tens of seconds of host time)
P21_MOE = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b")
P21_DRY = ROOT / "chiprun_out" / "dryrun_p21"


def p21_dryrun_start():
    """Start the dry run of gemma2-9b's long_500k and the MoE archs'
    prefill_32k cells on the single mesh in a subprocess (host only);
    returns it."""
    code = ("import sys; from repro_torch.launch import dryrun as d; "
            f"o = {str(P21_DRY)!r}; "
            "a = d.sweep(['gemma2-9b'], ['long_500k'], [False], 'fairkv_dp', o, "
            "dev_bytes=d.H100_BYTES); "
            f"b = d.sweep({list(P21_MOE)!r}, ['prefill_32k'], [False], 'fairkv_dp', o, "
            "dev_bytes=d.H100_BYTES); "
            "sys.exit(a['counts']['fail'] + b['counts']['fail'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def p21_dryrun(proc, records):
    """Phase 21 (c): the five cells' records: each executed its step and
    held its decode contract; prints args, peak and collectives."""
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"[p21] (c) the dry run of the new cells failed:\n{out[-3000:]}")
    recs = [r for r in records if r["arch"] in P21_MOE]
    for name in ("gemma2-9b__long_500k__single.json",) + tuple(
            f"{a}__prefill_32k__single.json" for a in P21_MOE):
        recs.append(json.loads((P21_DRY / name).read_text()))
    for rec in recs:
        ex = rec.get("executed")
        if rec.get("status") != "ok" or ex is None:
            fail(f"[p21] (c) {rec['arch']} {rec['shape']} did not execute its step: "
                 f"{rec.get('status')}")
        if "contract" in ex and not all(ex["contract"].values()):
            fail(f"[p21] (c) {rec['arch']} {rec['shape']}: contract {ex['contract']}")
        log(f"[p21] (c) {rec['arch']} {rec['shape']} on (data 16, model 16), {ex['step']}: "
            f"args {ex['memory']['argument_bytes']} B, peak {ex['memory']['peak_bytes']} B, "
            f"fits {rec['fits']} ({rec['device_bytes']} B); collectives "
            f"{ex['collectives_by_group']}")


def p21_runs(rows, moe_ref, records, dry):
    """Phase 21: (a) the long cell, (b) the MoE cell, (c) the new dry-run
    records; prints the seconds and the launches (apart from the kernel
    table, where the partial kernel's row carries (a)'s)."""
    t0 = time.perf_counter()
    la = p21_long(rows)
    gc.collect()
    lb_a, lb_b = p21_moe(moe_ref)
    p21_dryrun(dry, records)
    log(f"[p21] phase 21 took {time.perf_counter() - t0:.1f} s; launches (a) gloo rank 0 "
        f"{la}, (b) NCCL {lb_a}, gloo rank 0 {lb_b}")


# ---------------------------------------------------------------------------
# phase 22: the SSM, hybrid, encoder-decoder and VLM serve cells' step
# ---------------------------------------------------------------------------

P22_ARCHS = ("mamba2-1.3b", "hymba-1.5b", "whisper-small", "llava-next-34b")
# (b): two gloo ranks move every collective through host memory (phase 20
# (b)'s 8-layer prefill took ~20 s), so each arch runs with a shorter
# prompt and, where the plan bar allows, fewer layers: (decoder layers,
# prompt text tokens, rows); llava's prompts also hold its 2880 image
# tokens, whisper's encoder keeps its 12 layers over 1500 frames.  The bar
# n_layers 2^-8 max|logit| narrows with the depth faster than the partial
# sums' bf16 rounding does: hymba at 4 layers and llava at 4 missed it
# (0.1172 against 0.0669, 0.3516 against 0.1377 on an NVIDIA H100 80GB
# HBM3, 700.00 W)
P22_GLOO = {"mamba2-1.3b": (4, 512, B), "hymba-1.5b": (16, 128, B),
            "whisper-small": (12, WHISPER_PROMPT, B), "llava-next-34b": (12, 128, LLAVA_B)}
# (c) hymba-1.5b's long_500k cell at full width cut to 4 of 32 layers: its
# one window of 1024 (+ the 64-column ring), lengths drawn in [1000, 1024]
# and each layer's first owned slot full, so its appends wrap the ring,
# 16 steps (as phase 21's: over 72 steps 2 near-tied tokens of the split-S
# ranks flipped on the H100); the gloo ranks split the 1088
# columns over data 2: kernel 1's partial variant at G 5, Dh 64, window
# 1024.  mamba2-1.3b's long_500k (B 1, no cache) at full width, phase 17's
# 12 of 48 layers, one NCCL rank
P22_LONG = dict(arch="hymba-1.5b", layers=4, cap=1024, len_min=1000, steps=16, data=2,
                tag="[p22] (c)")
P22_MAMBA_LONG = dict(arch="mamba2-1.3b", layers=12, cap=1024, len_min=0, steps=16, data=1,
                      tag="[p22] (c)")
P22_DRY = ROOT / "chiprun_out" / "dryrun_p22"


def _p22_states(state) -> dict:
    """A serve state's SSD, conv window and cross attention tensors, copied
    to the host in their dtype (absent ones left out)."""
    out = {}
    for f in ("ssm_state", "conv_state", "cross_k", "cross_v"):
        t = getattr(state, f, None)
        if t is not None:
            out[f] = t.detach().cpu().clone()
    return out


def _p22_ref(ctx):
    """Phase 17's one-shot of an arch as phase 22 (a)'s reference: its
    config, profile and prompts, the local executor's eager run (result and
    final state) and the tokens that run was fed."""
    return {"cfg": ctx["cfg"], "profile": ctx["profile"], "prompts": ctx["prompts"],
            "slot_dp": ctx["eager"], "teacher": ctx["teacher"], "state": ctx["state"]}


def _p22_free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def p22_nccl(refs):
    """(a): each arch's phase-17 one-shot (full width; llava cut to 12 of
    60 layers) through the cell step on one NCCL rank (model 1, data 1):
    tokens, logits, lengths and the final SSD state, conv window and cross
    K / V bitwise the local executor's; the derived decode collectives;
    kernel 1 n_attn x GEN and kernel 2 n_attn launches (none for mamba2).
    Returns the launches."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    launches = {}
    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        for arch in P22_ARCHS:
            ref = refs[arch]
            m, want = ref["cfg"].model, ref["slot_dp"]
            run = p20_oneshot(mesh, ref)
            rows = want.tokens.shape[0]
            same = {"tokens": np.array_equal(run["tokens"], want.tokens),
                    "logits": np.array_equal(run["logits"], want.logits),
                    "lengths": np.array_equal(run["lengths"], want.lengths)}
            same.update({f: f in run["state"] and torch.equal(run["state"][f], t)
                         for f, t in ref["state"].items()})
            gap = float(np.abs(run["logits"] - want.logits).max())
            if not all(same.values()) or set(run["state"]) != set(ref["state"]):
                fail(f"[p22] (a) {arch}: not bitwise the local executor's: {same} (logit gap "
                     f"{gap}; state fields {sorted(run['state'])})")
            held = dryrun.decode_contract(run["collectives"], m, rows, 1, 1)
            if not all(held.values()):
                fail(f"[p22] (a) {arch}: decode collectives {run['collectives']} break the "
                     f"derived count {held}")
            n_attn = 0 if m.attention_free else m.n_layers
            got = run["launches"]
            if got["fairkv_decode"] != n_attn * GEN or got["snapkv_scores"] != n_attn:
                fail(f"[p22] (a) {arch}: launches {got}, want fairkv_decode {n_attn} x {GEN}, "
                     f"snapkv_scores {n_attn}")
            for k, v in got.items():
                launches[k] = launches.get(k, 0) + v
            log(f"[p22] (a) {arch} ({m.n_layers} layers, B {rows}, prompt "
                f"{ref['prompts']['tokens'].shape[1]} tokens, {GEN} steps) on one NCCL rank: "
                f"tokens, logits, lengths and {sorted(ref['state'])} bitwise the local "
                f"executor's; prefill {run['prefill_s']:.2f} s, eager decode step median "
                f"{run['step_ms']:.2f} ms; per decode step {run['collectives']}; launches {got}")
            run = ref = None
            _p22_free()
    finally:
        dist.destroy_process_group()
    return launches


def p22_gloo_ref(arch):
    """(b)'s reference: the local executor (eager) on ``arch`` cut as
    `P22_GLOO`, fairkv_dp, free-running `GEN` tokens from SyntheticLM's
    prompts."""
    from repro_torch.api import Engine
    from repro_torch.configs.base import InputShape
    from repro_torch.training.data import SyntheticLM
    layers, t, b = P22_GLOO[arch]
    cfg = family_config(arch, b, t, "fairkv_dp", 4)
    m = cfg.model.with_overrides(n_layers=layers)
    t_all = t + (m.num_image_tokens if m.is_vlm else 0)
    cfg = family_config(arch, b, t_all, "fairkv_dp", 4).replace(model=m)
    prompts = SyntheticLM(m, InputShape("chip_smoke", t_all, b, "prefill")).get_batch(0)
    eng = Engine.build(cfg)
    eng.executor = eager_executor(cfg)
    res = eng.generate(prompts, GEN)
    ref = {"cfg": cfg, "profile": eng.profile, "prompts": prompts, "slot_dp": res,
           "teacher": res.tokens[:, :GEN], "state": _p22_states(eng.state)}
    del eng
    _p22_free()
    return ref


def p22_gloo_rank(mesh, args):
    """One gloo rank of (b): each arch's cut one-shot through the cell step
    (its states as fp32 numpy), the cuBLAS workspace made first
    (`_cublas_workspace`)."""
    import torch
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 logs
    torch.backends.cuda.matmul.allow_tf32 = False
    _cublas_workspace(mesh.device)
    out = {}
    for arch, ref in args["refs"].items():
        run = p20_oneshot(mesh, ref, memory=True)
        run["state"] = {k: v.float().numpy() for k, v in run["state"].items()}
        out[arch] = run
        _p22_free()
    return out


def _p22_assemble(parts, want):
    """The ranks' shards of one state field put together along the dim
    their shape differs from the whole's (``want``) in, or rank 0's when
    every rank holds it whole (then every rank's must agree)."""
    import numpy as np
    dims = [d for d, (a, b) in enumerate(zip(parts[0].shape, want.shape)) if a != b]
    if not dims:
        if any(not np.array_equal(p, parts[0]) for p in parts[1:]):
            fail("[p22] (b) the ranks' whole state copies differ")
        return parts[0]
    return np.concatenate(parts, axis=dims[0])


def p22_gloo_check(arch, ref, ranks, predicted):
    """(b)'s bars for one arch on the two ranks' runs: the logit gap and
    every state field's gap under n_layers 2^-8 max|local| (the plan bar;
    for the cross K / V the encoder's layers and the projection's rounding
    count, n_encoder_layers + 1),
    each rank's peaks within `P21_PEAK_TOL` of the fake prediction, the
    derived decode collectives; the tokens' argmax agreement is printed."""
    import numpy as np
    from repro_torch.launch import dryrun
    m, want = ref["cfg"].model, ref["slot_dp"]
    rows = want.tokens.shape[0]
    logits = np.concatenate([r["logits"] for r in ranks], axis=-1)
    tol = m.n_layers * 2.0 ** -8 * float(np.abs(want.logits).max())
    gap = float(np.abs(logits - want.logits).max())
    agree = float((logits.argmax(-1) == want.logits.argmax(-1)).mean())
    problems = []
    if logits.shape != want.logits.shape or not np.isfinite(logits).all() or not gap < tol:
        problems.append(f"logits {logits.shape} (want {want.logits.shape}), gap {gap} (bar "
                        f"{tol}) or not finite")
    state_gaps, state_bars = {}, {}
    for f, w in ref["state"].items():
        wf = w.float().numpy()
        got = _p22_assemble([r["state"][f] for r in ranks], wf)
        n = m.n_encoder_layers + 1 if f.startswith("cross") else m.n_layers
        bar = state_bars[f] = n * 2.0 ** -8 * float(np.abs(wf).max())
        state_gaps[f] = float(np.abs(got - wf).max()) if got.shape == wf.shape else None
        if state_gaps[f] is None or not state_gaps[f] <= bar:
            problems.append(f"{f}: shape {got.shape} (want {wf.shape}), gap {state_gaps[f]} "
                            f"(bar {bar})")
    for r, got in enumerate(ranks):
        held = dryrun.decode_contract(got["collectives"], m, rows, P20_MODEL, 1)
        if not all(held.values()):
            problems.append(f"rank {r}: collectives {got['collectives']} break {held}")
        offs = {step: abs(predicted[step] - got["peak"][step]) / got["peak"][step]
                for step in ("prefill", "decode")}
        problems += [f"rank {r} {step}: peak {got['peak'][step]} B, predicted "
                     f"{predicted[step]} B ({100 * o:.1f}% off)"
                     for step, o in offs.items() if o > P21_PEAK_TOL]
        log(f"[p22] (b) {arch} gloo rank {r}: " + "; ".join(
            f"{step} peak {got['peak'][step]} B, predicted {predicted[step]} B "
            f"({100 * offs[step]:.2f}%)" for step in ("prefill", "decode"))
            + f"; per decode step {got['collectives']}; prefill {got['prefill_s']:.2f} s, "
            f"decode step median {got['step_ms']:.2f} ms")
    log(f"[p22] (b) {arch} ({m.n_layers} layers, B {rows}, prompt "
        f"{ref['prompts']['tokens'].shape[1]} tokens) on two gloo ranks (model {P20_MODEL}): "
        f"logit gap {gap:.5f} (bar {tol:.4f}), argmax agreement with the local run "
        f"{100 * agree:.1f}%, state gaps {state_gaps} (bars {state_bars}); tokens "
        f"{ranks[0]['tokens'][0].tolist()}")
    if problems:
        fail(f"[p22] (b) {arch}: " + "; ".join(problems))


def p22_long_kernel(ref, rows, launches):
    """Kernel 1's partial variant at hymba's long shape (B 1, G 5, Dh 64,
    window 1024) on (c)'s local final cache, layer 0, each data-2 shard of
    its 1088 columns: o and lse within FP32_TOL + 1e-5|plain| of the plain
    version, empty pairs o = 0, lse = -inf; timed on the second shard
    beside its bound, its plain version and the efficient SDPA.  Adds
    the ``*_g5`` keys to the partial kernel's row."""
    import torch
    from repro_torch.cache.slot_cache import shard_lengths
    from repro_torch.kernels.fairkv_decode import fairkv_decode_partial_cuda
    from repro_torch.kernels.ref import fairkv_decode_partial_ref
    from repro_torch.configs import get_config
    m = get_config(P22_LONG["arch"])
    cache, C = ref["cache"], ref["C"]
    c_loc = C // P22_LONG["data"]
    S, G, Dh = cache.k.shape[1], m.q_per_kv, m.head_dim
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED + 22)
    q = torch.randn((1, S, G, Dh), generator=gen, device="cuda").to(torch.bfloat16)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    err, live = 0.0, {}
    for c0 in (0, c_loc):
        cols = slice(c0, c0 + c_loc)
        k, v, kp = (t[0, :, :, cols].contiguous() for t in (cache.k, cache.v, cache.pos))
        args = (q, k, v, shard_lengths(cache.lengths[0], c0, c_loc), m.attn_softcap)
        kw = dict(k_pos=kp, q_pos=cache.positions, window=m.sliding_window)
        o, lse = fairkv_decode_partial_cuda(*args, **kw)
        o_ref, lse_ref = fairkv_decode_partial_ref(*args, **kw)
        torch.cuda.synchronize()
        empty = torch.isinf(lse_ref)
        if not (torch.equal(torch.isinf(lse), empty) and bool((o[empty] == 0).all())):
            fail(f"[p22] partial kernel (G {G}, columns {c0}+): empty pairs not o = 0, "
                 f"lse = -inf")
        name = f"fairkv_decode_partial (G {G}, Dh {Dh}, window {m.sliding_window}, columns {c0}+)"
        err = max(err, _cmp(name, o, o_ref, FP32_TOL, 1e-5),
                  _cmp(name + " lse", torch.where(~empty, lse, 0.0),
                       torch.where(~empty, lse_ref, 0.0), FP32_TOL, 1e-5))
        live[c0] = (int(empty.sum()), int((~empty).sum()))
        last = (args, kw)
    kern, plain, lib, bound, bound_by, nbytes, n_ret = _partial_times(*last, flush, "[p22]")
    for row in rows:
        if row["name"] == "fairkv_decode_partial":
            row.update(ms_g5=kern, plain_ms_g5=plain, bound_ms_g5=bound, bound_by_g5=bound_by,
                       library_ms_g5=lib, max_abs_err_g5=err, launches_g5=launches)
    log(f"[p22] partial kernel on (c)'s cache (B 1, S {S}, G {G}, Dh {Dh}, window "
        f"{m.sliding_window}, C_loc {c_loc}): o and lse within {FP32_TOL:g} + 1e-5|plain| of "
        f"the plain version (max err {err:.3e}); empty / live pairs per shard {live}")
    log(f"[time] fairkv_decode_partial at (B 1, S {S}, G {G}, C_loc {c_loc}, Dh {Dh}, window "
        f"{m.sliding_window}) bf16, sum(lengths) = {n_ret}: kernel {kern:.4f} ms, plain "
        f"{plain:.4f} ms, efficient SDPA {lib if lib is None else f'{lib:.4f}'} ms, bound "
        f"{bound:.4f} ms ({nbytes} B, {bound_by})")


def _p22_same_states(name, got, want, tag):
    """The run's final SSD state and conv window bitwise the local one's."""
    import torch
    same = {f: f in got and torch.equal(got[f], t) for f, t in want.items()}
    if not all(same.values()) or set(got) != set(want):
        fail(f"{tag} {name}: final state not bitwise the local executor's: {same}")


def p22_long(rows):
    """(c): hymba-1.5b's long_500k cell, the local executor, then the cell
    step on one NCCL rank (data 1) while two gloo ranks (data 2: the
    partial kernel) share the card; then mamba2-1.3b's long_500k on one
    NCCL rank; the partial kernel's checks and times at G 5.  Returns the
    gloo rank 0's launches."""
    import tempfile

    import numpy as np
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    t0 = time.perf_counter()
    cell, tag = P22_LONG, P22_LONG["tag"]
    predicted = p21_long_prediction(cell)
    ref = p21_long_local(cell)
    L, steps = ref["n_layers"], cell["steps"]
    if ref["launches"]["fairkv_decode"] != L * steps:
        fail(f"{tag} local executor launches {ref['launches']}")
    wrapped = int((ref["written"][0][:, 2] >= ref["C"] - MARGIN).sum())
    mamba = p21_long_local(P22_MAMBA_LONG)
    if any(mamba["launches"].values()):
        fail(f"{tag} mamba2's local executor launched kernels: {mamba['launches']}")
    join = p20_gloo_start({"send": {"teacher": ref["tokens"], "cell": cell}},
                          rank_fn=p21_long_rank, model=1, data=cell["data"])
    dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                            rank=0, world_size=1)
    try:
        mesh = make_host_mesh(model=1, data=1)
        one = p21_long_steps(mesh, ref["tokens"], cell=cell)
        one_m = p21_long_steps(mesh, mamba["tokens"], cell=P22_MAMBA_LONG)
    finally:
        dist.destroy_process_group()
    _, _, bitwise = p21_long_check("one NCCL rank", one, ref, 1, tag, cell)
    _p21_same_written("one NCCL rank", one["written"], ref["written"], tag=tag, n_layers=L)
    _p22_same_states("one NCCL rank", one["state"], ref["state"], tag)
    if not bitwise or one["launches"]["fairkv_decode"] != L * steps \
            or one["launches"]["fairkv_decode_partial"]:
        fail(f"{tag} one NCCL rank: logits bitwise {bitwise}, launches {one['launches']} "
             f"(want {L * steps} of kernel 1, none of the partial variant)")
    log(f"{tag} hymba-1.5b long_500k, one NCCL rank (data 1), {L} layers, B 1, C {ref['C']}, "
        f"{steps} steps: tokens, lengths, logits, the SSD state and conv window and "
        f"{len(one['written'][0])} written entries ({wrapped} in the ring) bitwise the local "
        f"executor's; eager step median {one['step_ms']:.2f} ms; per step "
        f"{one['collectives']}; launches {one['launches']}")
    _, _, bitwise_m = p21_long_check("mamba2 one NCCL rank", one_m, mamba, 1, tag, P22_MAMBA_LONG)
    _p22_same_states("mamba2 one NCCL rank", one_m["state"], mamba["state"], tag)
    if not bitwise_m or any(one_m["launches"].values()):
        fail(f"{tag} mamba2 one NCCL rank: logits bitwise {bitwise_m}, launches "
             f"{one_m['launches']}")
    log(f"{tag} mamba2-1.3b long_500k, one NCCL rank, {P22_MAMBA_LONG['layers']} layers, B 1, "
        f"{P22_MAMBA_LONG['steps']} steps: tokens, logits, the SSD state and conv window "
        f"bitwise the local executor's; eager step median {one_m['step_ms']:.2f} ms; per step "
        f"{one_m['collectives']}")
    ranks = join()
    problems = []
    for r, got in enumerate(ranks):
        gap_r, tol_r, _ = p21_long_check(f"gloo rank {r}", got, ref, cell["data"], tag, cell)
        if got["launches"]["fairkv_decode_partial"] != L * steps or \
                got["launches"]["fairkv_decode"]:
            problems.append(f"rank {r}: launches {got['launches']}")
        off = abs(predicted - got["peak"]) / got["peak"]
        if off > P21_PEAK_TOL:
            problems.append(f"rank {r}: peak {got['peak']} B, predicted {predicted} B "
                            f"({100 * off:.1f}% off)")
        sgap = {f: float(np.abs(got["state"][f] - w.float().numpy()).max())
                for f, w in ref["state"].items()}
        sbar = {f: L * 2.0 ** -8 * float(w.float().abs().max()) for f, w in ref["state"].items()}
        problems += [f"rank {r} {f}: gap {sgap[f]} > {sbar[f]}" for f in sgap
                     if not sgap[f] <= sbar[f]]
        log(f"{tag} hymba gloo rank {r} (data {cell['data']}, columns {got['cols']}): tokens "
            f"equal, lengths bitwise, logit gap {gap_r:.5f} (bar {tol_r:.4f}), state gaps "
            f"{sgap}; first step peak {got['peak']} B, predicted {predicted} B "
            f"({100 * off:.2f}%); eager step median {got['step_ms']:.2f} ms; per step "
            f"{got['collectives']}; launches {got['launches']}")
    keys = np.concatenate([g["written"][0] for g in ranks])
    vals = [np.concatenate([g["written"][1][i] for g in ranks]) for i in range(3)]
    order = np.lexsort(keys.T[::-1])
    kv_gap = _p21_same_written("gloo ranks", (keys[order], [x[order] for x in vals]),
                               ref["written"], bitwise=False, tag=tag, n_layers=L)
    if problems:
        fail(f"{tag} " + "; ".join(problems))
    p22_long_kernel(ref, rows, ranks[0]["launches"]["fairkv_decode_partial"])
    ref = mamba = None
    _p22_free()
    log(f"{tag} took {time.perf_counter() - t0:.1f} s; the gloo ranks' written entries: "
        f"places, positions and layer 0's K / V bitwise the local executor's, later layers' "
        f"K / V within {kv_gap:.5f}")
    return ranks[0]["launches"]


def p22_dryrun_start():
    """Start the dry run of the ten cells this phase adds (the SSM, hybrid,
    encoder-decoder and VLM archs at decode_32k and prefill_32k, hymba's
    and mamba2's long_500k) on the single mesh in a subprocess (host only,
    one thread; their 32k prefills take minutes); returns it."""
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from repro_torch.launch import dryrun as d; "
            f"o = {str(P22_DRY)!r}; "
            f"a = d.sweep({list(P22_ARCHS)!r}, ['decode_32k', 'long_500k', 'prefill_32k'], "
            "[False], 'fairkv_dp', o, dev_bytes=d.H100_BYTES); "
            "sys.exit(a['counts']['fail'])")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def p22_dryrun(proc):
    """(d): the ten cells' records: each executed its step (decode cells:
    their derived collectives held); prints args and peak GB per rank,
    fits and the collectives."""
    out, _ = proc.communicate(timeout=900)
    if proc.returncode != 0:
        fail(f"[p22] (d) the dry run of the new cells failed:\n{out[-3000:]}")
    n = 0
    for arch in P22_ARCHS:
        for shape in ("decode_32k", "long_500k", "prefill_32k"):
            path = P22_DRY / f"{arch}__{shape}__single.json"
            rec = json.loads(path.read_text())
            if rec["status"] == "skipped":
                continue
            ex = rec.get("executed")
            if rec["status"] != "ok" or ex is None:
                fail(f"[p22] (d) {arch} {shape} did not execute its step: {rec['status']}")
            if "contract" in ex and not all(ex["contract"].values()):
                fail(f"[p22] (d) {arch} {shape}: contract {ex['contract']}")
            n += 1
            log(f"[p22] (d) {arch} {shape} on (data 16, model 16): args "
                f"{ex['memory']['argument_bytes'] / 1e9:.2f} GB, peak "
                f"{ex['memory']['peak_bytes'] / 1e9:.2f} GB a rank, fits {rec['fits']} "
                f"({rec['device_bytes'] / 1e9:.1f} GB); {ex['step']} in {ex['seconds']} s; "
                f"collectives {ex['collectives_by_group']}")
    if n != 10:
        fail(f"[p22] (d) {n} new cells executed, want 10")


def p22_runs(rows, refs, dry):
    """Phase 22: (a) the four archs' one-shots on one NCCL rank while (b)'s
    two gloo ranks run their cut one-shots, (c) the long cells, (d) the
    dry-run records; prints the seconds and the launches (apart from the
    kernel table, where the partial kernel's row carries (c)'s)."""
    t0 = time.perf_counter()
    refs_b = {arch: p22_gloo_ref(arch) for arch in P22_ARCHS}
    # the predictions' fake process group and (a)'s NCCL one are this
    # process's default group in turn, so the predictions go first
    predicted = {arch: p20_prediction(r) for arch, r in refs_b.items()}
    sent = {arch: {k: r[k] for k in ("cfg", "profile", "prompts", "teacher")}
            for arch, r in refs_b.items()}
    join = p20_gloo_start({"send": {"refs": sent}}, rank_fn=p22_gloo_rank)
    t1 = time.perf_counter()
    la = p22_nccl(refs)
    refs = None
    _p22_free()
    t2 = time.perf_counter()
    ranks = join()
    # every arch's bars are checked and logged before (b) fails, and (c),
    # (d) run first: the phase fails at its end when any did
    failed = []
    for arch in P22_ARCHS:
        try:
            p22_gloo_check(arch, refs_b[arch], [r[arch] for r in ranks], predicted[arch])
        except RuntimeError as e:
            failed.append(str(e))
    lb = ranks[0]
    t3 = time.perf_counter()
    lc = p22_long(rows)
    t4 = time.perf_counter()
    p22_dryrun(dry)
    if failed:
        fail("; ".join(failed))
    log(f"[p22] phase 22 took {time.perf_counter() - t0:.1f} s ((b)'s references and "
        f"predictions {t1 - t0:.1f} s, (a) {t2 - t1:.1f} s beside (b)'s ranks, (b) after it "
        f"{t3 - t2:.1f} s, (c) {t4 - t3:.1f} s); launches (a) {la}, (b) rank 0 "
        f"{ {a: r['launches'] for a, r in lb.items()} }, (c) gloo rank 0 {lc}")


# ---------------------------------------------------------------------------
# phase 23: the dense train cells' sharded train step
# ---------------------------------------------------------------------------

P23_ARCH = "granite-3-2b"
# (a) one NCCL rank: bf16 params, fp32 master / mu / nu, B 2 x 4096 (past
# flash_threshold: the flash path and its recomputing backward), 4 of the
# 40 layers; (b) two gloo ranks sharing the card: fp32, B 2 x 2048, 2
# layers, at (data 1, model 2) and (data 2, model 1)
P23_A = dict(layers=4, B=2, T=4096, steps=2)
P23_B = dict(layers=2, B=2, T=2048, steps=2)
P23_LAYOUTS = ((1, 2), (2, 1))  # (data, model)
# lr 1e-3: at 1e-2 Adam's first update lr·g/(|g| + eps) turns the fp32
# rounding of a gradient near eps into steps past the 1e-4 bar, whatever
# the order of the sums (the single-process step against the JAX package's
# misses it at 1e-2 too)
P23_OPT = dict(lr=1e-3, warmup_steps=1, total_steps=3)
P23_TOL = 1e-4  # (b): metrics relative; shards rtol = atol
P23_DENSE = ("minitron-8b", "gemma2-9b", "granite-3-2b", "qwen1.5-110b")
P23_DRY = ROOT / "chiprun_out" / "dryrun_p23"
P23_METRICS = ("loss", "xent", "aux", "grad_norm", "lr")


def p23_config(layers):
    """granite-3-2b at full width cut to ``layers`` layers."""
    from repro_torch.configs import get_config
    return get_config(P23_ARCH).with_overrides(n_layers=layers)


def p23_batches(cfg, c):
    """``c["steps"]`` `SyntheticLM` batches of ``c["B"]`` x ``c["T"]`` (numpy)."""
    from repro_torch.configs import InputShape
    from repro_torch.training import SyntheticLM
    data = SyntheticLM(cfg, InputShape("chip_smoke", c["T"], c["B"], "train"))
    return [data.get_batch(s) for s in range(c["steps"])]


def p23_run(step, params, opt, batches, device, shard_batch=None):
    """``step`` over ``batches`` from (params, opt): the final (params, opt),
    each step's metrics (on the card), host-clocked seconds and
    collectives.  ``shard_batch`` cuts a batch to the rank's rows."""
    import torch
    from repro_torch.distributed import comm
    from repro_torch.launch.train import device_batch
    mets, times, colls = [], [], []
    for b in batches:
        batch = device_batch(b, device)
        if shard_batch is not None:
            batch = shard_batch(batch)
        torch.cuda.synchronize()
        before = comm.snapshot()
        t = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        colls.append(comm.by_kind(comm.since(before)))
        mets.append(met)
    return params, opt, mets, times, colls


def p23_nccl(cfg=None, c=P23_A, tag="[p23] (a)"):
    """(a): the cell step (`launch.specs.train_step`) on one NCCL rank (mesh
    (1, 1)) against the local `make_train_step` from the same seed-0
    weights and batches, both under deterministic algorithms: every
    metric of every step and every param and master / mu / nu leaf after
    the steps bitwise; the per-step collectives those `train_collectives`
    derives at (1, 1) (a group of one issues nothing).  Prints both
    steps' host-clocked times and the process's peak allocation over both
    runs.  ``cfg`` / ``c``: another config and size
    (phase 24's), granite-3-2b's at ``P23_A`` by default."""
    import tempfile

    import torch
    import torch.distributed as dist
    from repro_torch.distributed.param_specs import tree_specs
    from repro_torch.distributed.sharding import train_rules
    from repro_torch.launch import dryrun, specs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_params
    from repro_torch.training import OptimizerConfig, init_optimizer, make_train_step
    from repro_torch.configs import get_config
    from repro_torch.training.optimizer import tree_leaves, tree_map
    cfg = cfg or p23_config(c["layers"])
    batches = p23_batches(cfg, c)
    ocfg = OptimizerConfig(**P23_OPT)
    torch.cuda.reset_peak_memory_stats()

    def fresh():
        params = init_params(cfg, SEED, torch.bfloat16, "cuda", max_seq_len=c["T"])
        return params, init_optimizer(params)

    # the embedding's backward accumulates with atomics unless the
    # algorithms are deterministic
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        local = p23_run(make_train_step(cfg, ocfg, remat=True), *fresh(), batches, "cuda")
        # the local results wait on the host: two full-width trees with
        # their fp32 optimizer states need not share the card
        local = (tree_map(lambda x: x.cpu(), local[0]), tree_map(lambda x: x.cpu(), local[1]),
                 [{k: v.cpu() for k, v in m.items()} for m in local[2]]) + tuple(local[3:])
        gc.collect()
        torch.cuda.empty_cache()
        dist.init_process_group("nccl", init_method=f"file://{tempfile.mkdtemp()}/rendezvous",
                                rank=0, world_size=1)
        try:
            mesh = make_host_mesh(model=1, data=1)
            rules = train_rules(mesh)
            params, opt = fresh()
            fn = specs.train_step(cfg, mesh, rules, tree_specs(params, rules, "train"), c["B"],
                                  c["T"], ocfg)
            cell = p23_run(fn, params, opt, batches, "cuda")
        finally:
            dist.destroy_process_group()
    finally:
        torch.use_deterministic_algorithms(False)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
    differ = [f"step {i + 1} {k}" for i, (a, b) in enumerate(zip(local[2], cell[2]))
              for k in P23_METRICS if not torch.equal(a[k], b[k].cpu())]
    for what, a, b in (("params", local[0], cell[0]), ("optimizer state", local[1], cell[1])):
        la, lb = tree_leaves(a), tree_leaves(b)
        n = sum(not torch.equal(x, y.cpu()) for x, y in zip(la, lb))
        if n or len(la) != len(lb):
            differ.append(f"{n} of {len(la)} {what} leaves")
    held = [dryrun.train_contract(g, cfg, c["B"], c["T"], 1, 1, 1, c["T"]) for g in cell[4]]
    if differ or not all(all(h.values()) for h in held):
        fail(f"{tag} {cfg.name}: the cell step on one NCCL rank is not bitwise the local step: "
             f"{differ}; collectives {cell[4]} against the derived {held}")
    mets = [{k: float(v) for k, v in m.items()} for m in cell[2]]
    full = get_config(cfg.name)
    log(f"{tag} {cfg.name} ({c['layers']} of {full.n_layers} layers, full width, bf16 params, "
        f"fp32 master / mu / nu, B {c['B']} x {c['T']}, remat) on one NCCL rank: {c['steps']} cell "
        f"steps bitwise the local make_train_step (every metric, "
        f"{len(tree_leaves(cell[0]))} param and {len(tree_leaves(cell[1]))} optimizer leaves); "
        f"collectives per step {cell[4][0]} = train_collectives at (1, 1); metrics {mets}; "
        f"eager step s (host clock): cell {[round(t, 4) for t in cell[3]]}, local "
        f"{[round(t, 4) for t in local[3]]}; peak {torch.cuda.max_memory_allocated()} B "
        f"allocated")
    return {"cell_s": cell[3], "local_s": local[3]}


def _autograd_workspace(device) -> None:
    """One product's backward in each dtype the step uses, so that the
    workspace cuBLAS allocates for the backward's thread exists before a
    step's memory is measured (as `_cublas_workspace` for the forward)."""
    import torch
    for dt in (torch.bfloat16, torch.float32):
        w = torch.ones((64, 64), dtype=dt, device=device, requires_grad=True)
        (torch.ones((8, 64), dtype=dt, device=device) @ w).sum().backward()
    torch.cuda.synchronize()


def p23_shards(mesh, cfg, c, device, init_device=None, opt=P23_OPT):
    """The cell's arguments on ``mesh``'s rank: its shards of the seed-0 fp32
    weights (built whole on ``init_device``, default ``device``), a fresh
    optimizer state, the step (under ``opt``'s `OptimizerConfig`), the
    params' specs and the rows' cut."""
    import torch
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import train_rules
    from repro_torch.launch import specs
    from repro_torch.models import init_params
    from repro_torch.training import OptimizerConfig, init_optimizer
    from repro_torch.training.optimizer import tree_map
    rules = train_rules(mesh)
    whole = init_params(cfg, SEED, torch.float32, init_device or device, max_seq_len=c["T"])
    spec = tree_specs(whole, rules, "train")
    params = tree_map(lambda x: x.to(device), local_shard(whole, spec, mesh))
    del whole
    fn = specs.train_step(cfg, mesh, rules, spec, c["B"], c["T"], OptimizerConfig(**opt))
    rows = rules.guarded(c["B"], "batch")

    def cut(b):  # the rank's rows of the tokens and the stub frontends' inputs
        return local_shard(b, {k: (rows,) + (None,) * (v.dim() - 1) for k, v in b.items()}, mesh)
    return {"params": params, "opt": init_optimizer(params), "fn": fn, "spec": spec,
            "rows": cut}


def p23_prediction(data, model, cfg=None, c=P23_B):
    """(b)'s predicted peak at (``data``, ``model``): the first cell step
    on fake tensors on a fake mesh of that layout, rank 0's (the ranks'
    shapes are the same); a train cell's fake tensors live on the host
    (`dryrun.TRAIN_FAKE_DEVICE`).  ``cfg`` / ``c`` as `p23_nccl`'s."""
    from repro_torch.distributed import step_stats
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import fake_process_group, make_production_mesh
    from repro_torch.launch.train import device_batch
    cfg = cfg or p23_config(c["layers"])
    batch = p23_batches(cfg, dict(c, steps=1))[0]
    dev = dryrun.TRAIN_FAKE_DEVICE
    with fake_process_group(data * model), step_stats.fake_tensors():
        mesh = make_production_mesh(model=model, data=data, device=dev)
        a = p23_shards(mesh, cfg, c, dev)
        b = a["rows"](device_batch(batch, dev))
        _, st = step_stats.measure(a["fn"], (a["params"], a["opt"], b), a["params"], a["opt"], b)
    return st.peak_bytes


def p23_gloo_rank(mesh, args):
    """One gloo rank of (b): the cell steps on its shards, the first step's
    ``max_memory_allocated`` above the memory before its arguments and
    the collectives, then the local fp32 `make_train_step` on the whole
    tree on this rank's card, and the worst gap of each of the rank's
    param, master, mu and nu shards to the local result's slice, as a
    share of ``P23_TOL`` + ``P23_TOL`` |local|."""
    import torch
    from repro_torch.distributed.param_specs import local_shard
    from repro_torch.models import init_params
    from repro_torch.training import OptimizerConfig, init_optimizer, make_train_step
    from repro_torch.training.optimizer import tree_leaves
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 logs
    torch.backends.cuda.matmul.allow_tf32 = False
    _cublas_workspace(mesh.device)
    _autograd_workspace(mesh.device)
    c = P23_B
    cfg = p23_config(c["layers"])
    batches = p23_batches(cfg, c)
    gc.collect()
    base = torch.cuda.memory_allocated()
    a = p23_shards(mesh, cfg, c, mesh.device)
    peak = {}

    def first_step_peak(params, opt, batch):
        if not peak:
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        out = a["fn"](params, opt, batch)
        if not peak:
            torch.cuda.synchronize()
            peak["step"] = torch.cuda.max_memory_allocated() - base
        return out

    params, opt, mets, times, colls = p23_run(first_step_peak, a["params"], a["opt"], batches,
                                              mesh.device, a["rows"])
    a = dict(a, params=None, opt=None)
    whole = init_params(cfg, SEED, torch.float32, mesh.device, max_seq_len=c["T"])
    lp, lo, lmets, _, _ = p23_run(make_train_step(cfg, OptimizerConfig(**P23_OPT)), whole,
                                  init_optimizer(whole), batches, mesh.device)
    gaps = {}
    for name, mine, ref in (("params", params, lp), ("master", opt.master, lo.master),
                            ("mu", opt.mu, lo.mu), ("nu", opt.nu, lo.nu)):
        cut = local_shard(ref, a["spec"], mesh)
        gaps[name] = max(float(((x - y).abs() / (P23_TOL + P23_TOL * y.abs())).max())
                         for x, y in zip(tree_leaves(mine), tree_leaves(cut)))
    return {"mets": [{k: float(v) for k, v in m.items()} for m in mets],
            "local_mets": [{k: float(v) for k, v in m.items()} for m in lmets],
            "gaps": gaps, "peak": peak["step"], "collectives": colls[0], "step_s": times,
            "rank": (mesh.data_idx, mesh.model_idx)}


def p23_gloo_check(data, model, ranks, predicted, cfg=None, c=P23_B, tag="[p23] (b)"):
    """(b)'s bars at one layout: every step's loss, xent and grad norm (and
    lr) within ``P23_TOL`` relative of the local fp32 step's, every shard
    within ``P23_TOL`` of the local result's slice, each rank's peak within
    `P21_PEAK_TOL` of the prediction, and the derived collectives.
    ``cfg`` / ``c`` as `p23_nccl`'s."""
    from repro_torch.launch import dryrun
    cfg = cfg or p23_config(c["layers"])
    problems = []
    for r, got in enumerate(ranks):
        rel = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                  for a, b in zip(got["mets"], got["local_mets"])
                  for k in ("loss", "xent", "grad_norm", "lr"))
        off = abs(predicted - got["peak"]) / got["peak"]
        held = dryrun.train_contract(got["collectives"], cfg, c["B"] // data, c["T"], model,
                                     data, 1, c["T"])
        if not rel <= P23_TOL:
            problems.append(f"rank {r}: metrics {rel:.3e} off the local step's (relative)")
        problems += [f"rank {r} {k}: {g:.3f} of the bar" for k, g in got["gaps"].items()
                     if not g <= 1.0]
        if off > P21_PEAK_TOL:
            problems.append(f"rank {r}: peak {got['peak']} B, predicted {predicted} B "
                            f"({100 * off:.1f}% off)")
        if not all(held.values()):
            problems.append(f"rank {r}: collectives {got['collectives']} break {held}")
        log(f"{tag} {cfg.name} (data {data}, model {model}) gloo rank {r} {got['rank']}: metrics "
            f"within {rel:.2e} (relative) of the local fp32 step's, shards' worst gap "
            f"{ {k: round(g, 4) for k, g in got['gaps'].items()} } of the {P23_TOL:g} bar"
            f"{' (at ' + str(got['worst']) + ')' if 'worst' in got else ''}; "
            f"first step peak {got['peak']} B, predicted {predicted} B ({100 * off:.2f}%); "
            f"steps {[round(t, 3) for t in got['step_s']]} s (host clock); per step "
            f"{got['collectives']}")
    log(f"{tag} {cfg.name} (data {data}, model {model}): losses "
        f"{[round(m['loss'], 5) for m in ranks[0]['mets']]}, local "
        f"{[round(m['loss'], 5) for m in ranks[0]['local_mets']]}")
    if problems:
        fail(f"{tag} {cfg.name} (data {data}, model {model}): " + "; ".join(problems))


def p23_dryrun_start():
    """Start the dry run of the dense archs' train_4k cells, one subprocess
    a production mesh (host only, one thread each); returns them."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for multi in (False, True):
        code = ("import sys, torch; torch.set_num_threads(1); "
                "from repro_torch.launch import dryrun as d; "
                f"a = d.sweep({list(P23_DENSE)!r}, ['train_4k'], [{multi}], 'fairkv_dp', "
                f"{str(P23_DRY)!r}, dev_bytes=d.H100_BYTES); "
                "sys.exit(a['counts']['fail'])")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def p23_dryrun(procs):
    """(c): the eight dense train records: each executed the cell step,
    held its derived collectives and fits; prints argument, temp and peak
    GB a rank."""
    for proc in procs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"[p23] (c) the dry run of the train cells failed:\n{out[-3000:]}")
    for mesh in ("single", "multi"):
        for arch in P23_DENSE:
            rec = json.loads((P23_DRY / f"{arch}__train_4k__{mesh}.json").read_text())
            ex = rec.get("executed")
            if rec["status"] != "ok" or ex is None or not rec["fits"]:
                fail(f"[p23] (c) {arch} train_4k {mesh}: {rec['status']}, fits "
                     f"{rec.get('fits')}")
            if not all(ex["contract"].values()):
                fail(f"[p23] (c) {arch} train_4k {mesh}: contract {ex['contract']}")
            m = ex["memory"]
            log(f"[p23] (c) {arch} train_4k on the {mesh} mesh: args "
                f"{m['argument_bytes'] / 1e9:.2f} GB, temp {m['temp_bytes'] / 1e9:.2f} GB, "
                f"peak {m['peak_bytes'] / 1e9:.2f} GB a rank, fits {rec['fits']} "
                f"({rec['device_bytes'] / 1e9:.1f} GB); contract held; {ex['step']} in "
                f"{ex['seconds']} s; collectives {ex['collectives_by_group']}")


def p23_runs(dry):
    """Phase 23: (b)'s predictions, then (a) on one NCCL rank while (b)'s
    two layouts' gloo ranks run, then (b)'s bars and (c)'s records;
    prints the seconds."""
    t0 = time.perf_counter()
    # the predictions' fake process group and (a)'s NCCL one are this
    # process's default group in turn, so the predictions go first
    predicted = {lay: p23_prediction(*lay) for lay in P23_LAYOUTS}
    joins = {lay: p20_gloo_start({}, rank_fn=p23_gloo_rank, model=lay[1], data=lay[0])
             for lay in P23_LAYOUTS}
    t1 = time.perf_counter()
    p23_nccl()
    t2 = time.perf_counter()
    for lay, join in joins.items():
        p23_gloo_check(*lay, join(), predicted[lay])
    t3 = time.perf_counter()
    p23_dryrun(dry)
    log(f"[p23] phase 23 took {time.perf_counter() - t0:.1f} s (predictions {t1 - t0:.1f} s, "
        f"(a) {t2 - t1:.1f} s beside (b)'s ranks, (b) after it {t3 - t2:.1f} s)")


# ---------------------------------------------------------------------------
# phase 24: the MoE, SSM, hybrid, encoder-decoder and VLM train cells' step
# ---------------------------------------------------------------------------

P24_ARCHS = ("granite-moe-1b-a400m", "mamba2-1.3b", "hymba-1.5b", "whisper-small",
             "llava-next-34b")
# (c)'s dry-run archs: the six non-dense archs' train_4k cells on both meshes
P24_DRY_ARCHS = ("granite-moe-1b-a400m", "qwen3-moe-30b-a3b", "mamba2-1.3b", "hymba-1.5b",
                 "whisper-small", "llava-next-34b")
# (a) one NCCL rank: bf16 params, fp32 master / mu / nu, B 2 x the train_4k
# row (4096 positions; llava's 2880 image + 1216 text), 2 layers (whisper 2
# encoder + 2 decoder); (b) two gloo ranks sharing the card at (data 1,
# model 2): fp32, 1 layer (whisper 1 + 1), B 2 x 1024 (llava 2880 + 256)
P24_A = dict(layers=2, B=2, T=4096, steps=2)
P24_B = dict(layers=1, B=2, T=1024, steps=2)
P24_LLAVA_B_TEXT = 256
P24_LAYOUT = (1, 2)  # (data, model)
# (b)'s optimizer: phase 23's with Adam's eps 1e-6 (the reference's 1e-8 in
# (a)).  The update lr·m̂/(√v̂ + eps) divides a gradient near zero by about
# eps, so at 1e-8 the fp32 rounding of the sharded products (median 3e-6
# relative at mamba2's and llava's widths) moved single mamba2 and llava
# params 4.5x and 2.0x the 1e-4 bar past the local step's; at 1e-6 the
# update still moves every param with |g| >> 1e-6 by lr, 10x the bar
P24_OPT = dict(P23_OPT, eps=1e-6)
# (b)'s local runs take turns when a whole fp32 tree with its master / mu /
# nu (16 B a parameter) passes this: llava's 1.47 B parameters at 1 layer.
# Such an arch also waits until (a)'s llava has left the card: beside (a)'s
# llava trees (52.3 GB allocated) its ranks ran out of the card's 80 GB
P24_SERIAL_BYTES = 8 * 2**30
P24_GATE_S = 900
P24_DRY = ROOT / "chiprun_out" / "dryrun_p24"


def p24_case(arch, c):
    """``arch`` at full width cut to ``c["layers"]`` layers (an
    encoder-decoder's encoder too), and ``c`` with its row's positions
    (llava's (b): its image prefix and ``P24_LLAVA_B_TEXT`` tokens)."""
    from repro_torch.configs import get_config
    full = get_config(arch)
    over = {"n_layers": c["layers"]}
    if full.is_encoder_decoder:
        over["n_encoder_layers"] = c["layers"]
    if full.is_vlm and c is P24_B:
        c = dict(c, T=full.num_image_tokens + P24_LLAVA_B_TEXT)
    return full.with_overrides(**over), c


def _named_leaves(tree, path=""):
    """(path, tensor) of a dict / list tree's leaves, in `tree_leaves`' order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}.{i}")
    else:
        yield path.lstrip("."), tree


def p24_gloo_rank(mesh, args):
    """One gloo rank of (b), every arch in turn: first the local fp32
    `make_train_step` on the whole tree (one rank at a time where the whole
    tree with its optimizer state passes `P24_SERIAL_BYTES`, so that two
    never share the card, and not before ``args["gate"]`` exists: (a)'s
    llava has left the card), its slice of the results kept on the host; then
    the cell steps on the rank's shards, the first step's
    ``max_memory_allocated`` above the memory before its arguments, and
    the worst gap of each param, master, mu and nu shard to the local
    slice as a share of ``P23_TOL`` + ``P23_TOL`` |local| (on the card)."""
    import torch
    import torch.distributed as dist
    from repro_torch.distributed.param_specs import local_shard, tree_specs
    from repro_torch.distributed.sharding import train_rules
    from repro_torch.models import init_params
    from repro_torch.training import OptimizerConfig, init_optimizer, make_train_step
    from repro_torch.training.optimizer import tree_leaves, tree_map
    if mesh.rank:
        sys.stdout = open(os.devnull, "w")  # rank 0 logs
    torch.backends.cuda.matmul.allow_tf32 = False
    _cublas_workspace(mesh.device)
    _autograd_workspace(mesh.device)
    out = {}
    for arch in P24_ARCHS:
        cfg, c = p24_case(arch, P24_B)
        batches = p23_batches(cfg, c)
        spec = None
        serial = 16 * cfg.param_count() > P24_SERIAL_BYTES
        if serial:
            waited = time.perf_counter()
            while not os.path.exists(args["gate"]):
                if time.perf_counter() - waited > P24_GATE_S:
                    fail(f"[p24] (b) {arch}: (a)'s llava did not leave the card in "
                         f"{P24_GATE_S} s")
                time.sleep(0.2)
        for r in range(mesh.world) if serial else [mesh.rank]:
            if r == mesh.rank:
                whole = init_params(cfg, SEED, torch.float32, mesh.device, max_seq_len=c["T"])
                spec = tree_specs(whole, train_rules(mesh), "train")
                lp, lo, lmets, _, _ = p23_run(make_train_step(cfg, OptimizerConfig(**P24_OPT)),
                                              whole, init_optimizer(whole), batches, mesh.device)
                ref = {k: tree_map(lambda x: x.cpu(), local_shard(t, spec, mesh))
                       for k, t in (("params", lp), ("master", lo.master), ("mu", lo.mu),
                                    ("nu", lo.nu))}
                lmets = [{k: float(v) for k, v in m.items()} for m in lmets]
                del whole, lp, lo
                gc.collect()
                torch.cuda.empty_cache()
            if serial:
                dist.barrier()
        gc.collect()
        base = torch.cuda.memory_allocated()
        a = p23_shards(mesh, cfg, c, mesh.device, opt=P24_OPT)
        peak = {}

        def first_step_peak(params, opt, batch):
            if not peak:
                gc.collect()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
            res = a["fn"](params, opt, batch)
            if not peak:
                torch.cuda.synchronize()
                peak["step"] = torch.cuda.max_memory_allocated() - base
            return res

        params, opt, mets, times, colls = p23_run(first_step_peak, a["params"], a["opt"],
                                                  batches, mesh.device, a["rows"])
        a = None
        gaps, worst = {}, {}
        names = [k for k, _ in _named_leaves(params)]
        for name, mine in (("params", params), ("master", opt.master), ("mu", opt.mu),
                           ("nu", opt.nu)):
            per = []
            for x, y in zip(tree_leaves(mine), tree_leaves(ref[name])):
                y = y.to(x.device)
                per.append(float(((x - y).abs() / (P23_TOL + P23_TOL * y.abs())).max()))
            gaps[name] = max(per)
            worst[name] = names[per.index(gaps[name])]
        out[arch] = {"mets": [{k: float(v) for k, v in m.items()} for m in mets],
                     "local_mets": lmets, "gaps": gaps, "worst": worst, "peak": peak["step"],
                     "collectives": colls[0], "step_s": times,
                     "rank": (mesh.data_idx, mesh.model_idx)}
        # nothing of this arch may outlive it: the next arch's peak counts
        # from the memory allocated before its arguments
        del params, opt, ref, first_step_peak
        gc.collect()
        torch.cuda.empty_cache()
    return out


def p24_dryrun_start():
    """Start the dry run of the six non-dense archs' train_4k cells, one
    subprocess a production mesh (host only, one thread each)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = []
    for multi in (False, True):
        code = ("import sys, torch; torch.set_num_threads(1); "
                "from repro_torch.launch import dryrun as d; "
                f"a = d.sweep({list(P24_DRY_ARCHS)!r}, ['train_4k'], [{multi}], 'fairkv_dp', "
                f"{str(P24_DRY)!r}, dev_bytes=d.H100_BYTES); "
                "sys.exit(a['counts']['fail'])")
        procs.append(subprocess.Popen([sys.executable, "-c", code], cwd=str(ROOT), env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    return procs


def p24_dryrun(procs):
    """(c): the twelve new train records (the six archs on both production
    meshes): each executed its step, held its derived collectives and
    fits; prints argument, temp and peak GB a rank."""
    for proc in procs:
        out, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            fail(f"[p24] (c) the dry run of the train cells failed:\n{out[-3000:]}")
    for mesh in ("single", "multi"):
        for arch in P24_DRY_ARCHS:
            rec = json.loads((P24_DRY / f"{arch}__train_4k__{mesh}.json").read_text())
            ex = rec.get("executed")
            if rec["status"] != "ok" or ex is None or not rec["fits"]:
                fail(f"[p24] (c) {arch} train_4k {mesh}: {rec['status']}, fits "
                     f"{rec.get('fits')}")
            if not all(ex["contract"].values()):
                fail(f"[p24] (c) {arch} train_4k {mesh}: contract {ex['contract']}")
            m = ex["memory"]
            log(f"[p24] (c) {arch} train_4k on the {mesh} mesh: args "
                f"{m['argument_bytes'] / 1e9:.2f} GB, temp {m['temp_bytes'] / 1e9:.2f} GB, "
                f"peak {m['peak_bytes'] / 1e9:.2f} GB a rank, fits {rec['fits']} "
                f"({rec['device_bytes'] / 1e9:.1f} GB); contract held; {ex['step']} in "
                f"{ex['seconds']} s")


def p24_runs(dry):
    """Phase 24: (b)'s predictions, then (a) for each arch on one NCCL rank
    while (b)'s two gloo ranks run every arch, then (b)'s bars and (c)'s
    records; prints the seconds."""
    import tempfile

    import torch
    t0 = time.perf_counter()
    data, model = P24_LAYOUT
    predicted = {arch: p23_prediction(data, model, *p24_case(arch, P24_B))
                 for arch in P24_ARCHS}
    gate = f"{tempfile.mkdtemp()}/a_done"
    join = p20_gloo_start({"send": {"gate": gate}}, rank_fn=p24_gloo_rank, model=model,
                          data=data)
    t1 = time.perf_counter()
    # (a)'s largest arch (llava) first, while (b) runs the small archs;
    # then the gate opens and (b)'s llava, whose whole fp32 tree would not
    # share the card with (a)'s llava trees, runs beside (a)'s small archs
    order = sorted(P24_ARCHS, key=lambda a: -p24_case(a, P24_A)[0].param_count())
    took = {}
    try:
        for arch in order:
            t = time.perf_counter()
            p23_nccl(*p24_case(arch, P24_A), tag="[p24] (a)")
            gc.collect()
            torch.cuda.empty_cache()
            took[arch] = round(time.perf_counter() - t, 1)
            if arch == order[0]:
                Path(gate).touch()
    finally:
        Path(gate).touch()
    t2 = time.perf_counter()
    ranks = join()
    failed = []
    for arch in P24_ARCHS:  # every arch's bars are printed before a failure
        cfg, c = p24_case(arch, P24_B)
        try:
            p23_gloo_check(data, model, [r[arch] for r in ranks], predicted[arch], cfg, c,
                           tag="[p24] (b)")
        except RuntimeError as e:
            failed.append(str(e))
    if failed:
        fail("; ".join(failed))
    t3 = time.perf_counter()
    p24_dryrun(dry)
    log(f"[p24] phase 24 took {time.perf_counter() - t0:.1f} s (predictions {t1 - t0:.1f} s, "
        f"(a) {t2 - t1:.1f} s beside (b)'s ranks ({took}), (b) after it {t3 - t2:.1f} s, (c) "
        f"after that {time.perf_counter() - t3:.1f} s)")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs the port on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT} does not hold the repository's src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # fp32 matmuls in full fp32 (the default, stated): TF32 would loosen the
    # fp32 checks to ~1e-3
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    def mark(what):  # the phases' end times, for the record of where time goes
        log(f"[time] {what} ended {time.perf_counter() - t_start:.1f} s after the start")

    card = card_line()
    log(f"[card] {card}")
    build_kernels()
    mark("phase 2 (build)")
    # phase 19 (c)'s fake decode steps, phase 22 (d)'s fake prefills and
    # phases 23 (c)'s and 24 (c)'s fake train steps run on the host from here on
    dry19 = p19_sweep_start()
    dry22 = p22_dryrun_start()
    dry23 = p23_dryrun_start()
    dry24 = p24_dryrun_start()
    for proc in [dry19, dry22] + dry23 + dry24:
        atexit.register(lambda p=proc: p.poll() is None and (p.kill(), p.wait()))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    check_decode(gen)
    check_decode_segments(gen)
    check_head_dim_refusals(gen)
    check_scores(gen)
    check_paged()
    check_paged_mq()
    check_paged_contracts()
    smoke_parity()
    smoke_spec_parity()
    mark("phases 3-4")
    engine, launches, ctx = main_path()
    paged = paged_oneshot(ctx)
    cont, mq_inputs = continuous_runs(ctx)
    prefix = prefix_runs(ctx)
    mark("phases 5-8")
    graphs_vs_eager(ctx)
    mark("phase 9")
    # phases 12-14 run before the timings, so their launches are in the table
    policies = policy_runs(ctx)
    cli_run()
    frontend = frontend_runs(ctx)
    # each phase of the main path counts its own launches (zeroed just
    # before, read just after): one-shot slot, one-shot paged, continuous,
    # chunked prefill and prefix reuse, the policies, the front end
    for k in launches:
        launches[k] += (paged["launches"][k] + cont[k] + prefix[k] + policies[k]
                        + frontend.get(k, 0))
    log(f"[main] launches over the whole main path: {launches} (of them in the chunked / "
        f"prefix phase: {prefix}; in the policy phase: {policies}; in the front-end "
        f"phase: {frontend})")
    for name, n in launches.items():
        # kernel 1's partial variant runs on phase 21's split-S path, which
        # counts it apart
        if n == 0 and name != "fairkv_decode_partial":
            fail(f"kernel {name} was never launched on the main path")
    for name in ("snapkv_scores", "paged_fairkv_decode"):
        if prefix[name] == 0:
            fail(f"kernel {name} was never launched in the chunked / prefix phase")
    mark("phases 12-14")
    rows = time_kernels(engine, launches, paged, mq_inputs, prefix)
    attribute_elementwise(engine)
    oneshot_beside_scheduler(ctx)
    mark("phases 10-11")
    # phase 15 last: its second part starts two ranks that each hold a full
    # copy of the weights, so the main path's engines go first
    engine = paged = cont = mq_inputs = prefix = policies = frontend = None
    gc.collect()
    torch.cuda.empty_cache()
    mesh_runs(ctx)
    # phase 20 reruns phase 5's one-shot; its weights come again from the seed
    p20_ref = {k: ctx[k] for k in ("cfg", "profile", "prompts", "slot_dp", "teacher")}
    # phase 16 after phase 15: every engine of the phases before is gone
    ctx = None
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 15")
    p21_moe_ref = family_runs(rows)
    # phase 17 after phase 16, its memory freed
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 16")
    p22_refs = p17_runs(rows)
    # phase 18 after phase 17, its memory freed
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 17")
    # phase 18 (c)'s training CLI runs beside phases 19 and 20
    p18_cli = p18_runs(rows)
    gc.collect()
    torch.cuda.empty_cache()
    mark("phase 18")
    records = p19_runs(dry19)
    mark("phase 19")
    # phase 21 (c)'s fake prefills run on the host beside phases 20 and 21
    dry = p21_dryrun_start()
    try:
        p20_runs(p20_ref, records)
        p18_cli()
        mark("phase 20 (and 18 (c))")
        gc.collect()
        torch.cuda.empty_cache()
        p21_runs(rows, p21_moe_ref, records, dry)
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    mark("phase 21")
    gc.collect()
    torch.cuda.empty_cache()
    p22_runs(rows, p22_refs, dry22)
    mark("phase 22")
    gc.collect()
    torch.cuda.empty_cache()
    p23_runs(dry23)
    mark("phase 23")
    gc.collect()
    torch.cuda.empty_cache()
    p24_runs(dry24)
    mark("phase 24")
    log(f"[done] {time.perf_counter() - t_start:.1f} s in all")
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
