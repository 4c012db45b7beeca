#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (the script exits non-zero before the
last line):
  1. card   — CUDA device present; nvidia-smi name and power limit.
  2. build  — nvcc builds the kernels from src/repro_torch/kernels/csrc
              (ptxas registers, shared memory and spills printed).
 2b. analysis — the port's serving-contract analyzer
              (repro_torch.analysis, in process, --strict) on the card:
              the AST layer; the launch lint's 13 workloads planned from
              the wrappers' rules, run, and every planned launch matched
              to one real build.launch; the work-unit layer over the 13
              flag combos and the reference's tensor-parallel ones (3,
              kernel folded; two mesh positions spread over the card)
              (each unit of each combo called 3+ times, one
              program and one CUDA graph each, bodies recorded and
              replays under sync debug mode "error", the pool updated in
              place, the paged kernels launched).  Findings by layer,
              units x combos, captures, planned vs matched launches and
              the phase's seconds printed; any finding fails.
  3. kernels — each paged kernel against its plain PyTorch version at
              yi-6b's serving shape, llama-te-mini's heads (hd 64),
              zamba2-2.7b's attention (hd 80) and yi-6b's decode_32k
              shape (B=8, every slot within bs of 32768 positions, bf16;
              the chunk's plain version slot by slot), bf16 and float32
              q, over pools of q's dtype (paged_decode, paged_chunk) and
              over e4m3 pools with per-row scales (paged_decode_fp8,
              paged_chunk_fp8): each call on the body and plan (splits,
              rows, shared memory) its rule names, counted there once;
              max abs error within its limit (bf16 also within one
              bf16 step of each row's max |o|), kernel time back to back
              (CUDA events) and as device time (a CUDA-graph replay),
              plain time, the time of PyTorch's
              scaled_dot_product_attention over the gathered (for fp8:
              gathered and dequantized, untimed) view, back to back and
              device (a yardstick the port never calls), and the bound.
              Then paged_chunk and paged_chunk_fp8 at the verify shape
              (yi-6b heads, B=8, C=5 = spec decode K=4, 128 cached
              tokens a slot), the same numbers; then the four kernels
              past the held scores (yi-6b heads, every slot at 131072
              positions, decode B=2 and a 16-row chunk B=1, bf16 and
              e4m3 pools; float32 q at 65536) on the plan that
              recomputes the scores, against plain (the chunk's row by
              row), with the byte time of K twice and V once beside the
              bound.
  4. forward — full-width yi-6b, its depth cut to SERVE_LAYERS (8 of
              32) for the script's time limit, as in phases 5-6
              (random bf16 weights, seed 0):
              a chunk_step and decode_steps through the kernels, every
              kernel call held against its plain version on the same
              inputs; the end-to-end logits against the plain path are
              printed (random weights make the deep stack chaotic:
              a one-step rounding difference grows layer by layer).
              Then the same with an e4m3 pool and fp8 linears.
  5. serve  — ChunkedServer on full-width yi-6b: a ShareGPT-like wave
              (paper Table XII protocol) and a shared-system-prompt
              wave (radix prefix cache + copy-on-write); every request
              complete at its expected length, both kernels launched,
              L x steps each, and as many launches run on the card
              (the kernel's own counter).  Every work unit replays one
              CUDA graph:
              compile_counts(), captures and the graph pool's bytes
              printed, each unit one program and captured once; a fresh
              server whose units run eagerly serves both waves again
              and must give the same streams bit for bit.  Then all of
              it on ChunkedServer(fp8_kv=True, fp8_linear=True): both
              fp8 kernels launched, every copy-on-write copies the
              scales, and the pool holds exactly (hd+4)/(2*hd) of the
              bf16 pool's bytes.
 5b. spec   — the verify work unit on full-width yi-6b (8 slots, chunk
              16, span 8, block 16, max_len 96, prefix cache; 8
              repetitive requests, two 8-token motifs x 3, 48 new
              tokens: the reference's spec A/B), bf16 then fp8 (e4m3
              pool + fp8 linears): a greedy K=0 wave through the units'
              eager calls (recorded) and one through their graphs on a
              fresh server (timed; equal tokens bit for bit), then a
              K=4 cold and warm wave on one spec server (graphs) and on
              a fresh one whose units run eagerly, which must repeat
              them exactly; every server's compile_counts() printed,
              each unit one program, captured once where graphed.  K=4 against K=0 is printed, not held: each
              stream's first parting with the K=0 run's top-2 margin
              there (the random-weight stack turns the verify and decode
              steps' rounding into O(1) logits; the verify step's kernel
              calls are held to plain instead, and token streams at the
              reduced size, phase 7).  Every spec wave's streams are
              rebuilt exactly from its verify steps' own windows,
              positions and returned tokens; a warm wave whose drafts
              stay out of the numerics (bf16; in the fp8 phase an e4m3
              pool with bf16 linears) accepts at least ACCEPT_FLOOR of
              them (with fp8 linears the drafts enter the per-call
              activation scale: printed only).  bf16 also: a sampled
              wave (temperature 0.5, top-k 4, seeds 300+i) K=0 against
              K=4 warm (partings printed) and a KS test of K=4 against
              K=0 at temperature 1.0 with disjoint seeds (p > 0.01).
              Every spec wave launches the decode kernel 0 times and the
              chunk kernel L x chunk steps in its chunk steps and L x
              verify steps in its verify steps, counted around each
              dispatch, and as many run on the card; acceptance, tokens a slot a verify step and wall
              tokens/s against K=0 printed.
 5c. contiguous — ChunkedServer(paged=False) on full-width yi-6b, bf16:
              phase 5's ShareGPT wave cold and warm (graphs; compile
              counts {chunk_step, decode_span}, no cow_copy; tokens/s
              beside phase 5's paged server and a paged server without
              prefix cache), spec K=4 on 5b's traffic on a graphed and
              an eager-unit server (equal bit for bit), no paged kernel
              run (the kernel's counter on the card and the wrappers');
              each stream's first parting from the paged streams
              printed with the paged top-2 margin there; a chunk and a
              decode step on a contiguous cache, every plain attention
              call held to the paged kernel on the same inputs.
 5d. slot   — the reference's Table XII rows at full width: SlotServer,
              contiguous and paged ChunkedServer on 8 ShareGPT-like
              requests (4 slots, max_len 96), first waves (chunked also
              warm): tokens/s, chunked / slot; the slot server's compile
              counts and captures; no paged kernel run.
 5e. online — open-loop serving on phase 5's server and wave, bf16 then
              fp8 KV + fp8 linears: serve_online(closed_stream) equals
              serve() (streams, admission order, compile counts); sync
              debug mode finds no synchronization of a warm online wave
              that serve() does not have, none inside a unit call; the
              reference's rate sweep (calibrate at 0.5x the closed-loop
              rate, SLO 2x its p99 TTFT / TPOT; Poisson at 0.5x, 1x, 3x)
              with TTFT, TPOT, queue delay, attainment, goodput, peak
              queue depth and windows; in bf16 every sample-head row
              of the calibration and of each rate is recorded through
              the graphs, and every row whose stream and work-unit
              history up to it equal the calibration's must have its
              logits bit for bit (a row that depends on its neighbours
              fails), each recorded row's argmax must be the emitted
              token, and a stream may part only after another unit's
              token; the paged kernel's counter equals the wrappers'.
  6. profile — wall and device time of the full-width server's work
              units as graph replays (a span of 8 decode steps, a chunk
              step, a verify step at K=4; sample head in each), bf16
              and fp8: wall around a replay and its sync, device by
              CUDA events around back-to-back replays, the kernels that
              take the device time (torch.profiler over replays; no
              kernel seen fails), the paged kernel's launches run on
              the card over those replays (its own counter) against
              the unit's captured count, the graph pool's bytes; the
              sample head alone over [8, 64000] and [8, 5, 64000],
              eager and replayed.
  7. small  — the reduced yi-6b served through the kernels on the card
              (graph replays; the recorded waves through the eager
              units) and through the plain versions on the CPU, bf16
              and fp8,
              greedy and sampled with spec decode K=3: equal token
              streams, except where the CPU's own draw is within the
              margin of another; in bf16 also spec K=3 against K=0 on
              the card, greedy and sampled, by the same rule; by the
              same rule serve_online(closed_stream) on the card against
              the CPU's serve(), and in bf16 the contiguous layout and
              SlotServer, card against CPU; in bf16 the reduced
              yi-6b at tp=2 on a mesh spread over the card (greedy, and
              sampled with spec K=3) against the CPU's tp=1, by the
              same rule.
  8. matmul — the tensor-core and async-copy kernels (matmul,
              single_tile_matmul, fp8_matmul, pipelined_matmul) against
              their plain versions at the dissection benchmarks' shapes
              and at yi-6b's full-width MLP up-projection for a
              2048-token prefill (M=2048, K=4096, N=11008): bf16 over a
              tile sweep (bn 64/128/256 at bm=128, bk 128 and 64), int8
              and e4m3 with B column-major and contiguous (the layout
              copy's ms printed apart), e5m2, float32 on the fma_tma
              body at (128, 128, 128) and 64^3 and, with A off 16
              bytes, on the fma body (the before and after of one
              call); single_tile_matmul
              at the nine tc_mma cases; pipelined_matmul at 16^3, 32^3
              and 64^3 tiles, stages 1-3, at the async_copy shape and at
              full width, and at 128 x 128 with the fma_tma ring's two
              64-deep stages and four 32-deep ones; ops.fp8_matmul
              with auto tiles (the tile model's sweep on the warpgroup
              grid) at full width, B column-major and contiguous, on
              the wgmma body.  Each case's body
              (wgmma, mma_sync, fma, fma_tma; tma, staged; tma,
              cp_async) by its rule, held to the source's
              own rule and to the per-body launch count; max abs error
              within its limit, kernel ms (CUDA events, back-to-back
              calls; for the one-block single_tile_matmul also the
              device ms of a CUDA-graph replay and its one-SM bound),
              plain ms, a one-call PyTorch yardstick the port never
              calls (torch.matmul, torch._scaled_mm, torch._int_mm),
              the bound and TFLOP/s; the SyncShare/AsyncPipe ratio per
              block size at full width and at the async_copy shape;
              four probes, findings and not gates (native e4m3
              mma.sync, csrc/fp8_mma_probe.cu; TMA + mbarrier + wgmma
              descriptors, csrc/wgmma_probe.cu; float32 TMA boxes under
              each swizzle, csrc/tma_probe.cu; the fp8 wgmma body's
              error with and without its promotion, from a copy of the
              sources built without it); then the five dissection
              benchmarks (repro_torch.benchmarks.run) through the
              kernels.
  9. dpx_dsm — the DPX kernels (dpx_fused, tropical_matmul,
              smith_waterman) and the thread-block-cluster kernels
              (rbc_ring_copy, ring_latency_probe, histogram_private,
              histogram_dsm, all_to_all_exchange) against their plain
              versions, exactly (integers equal, float32 bitwise), at
              the benchmarks' own inputs and at full size: the DPX
              functions over 2**26 int32 / int16 elements (an odd
              length too) with values at the type limits; the (max,+)
              product at M=N=K=64 and 2048 on its tma body, and at 2048
              on its staged body (tiles 32^3 and 64/64/32, forced by
              the rule with A off 16 bytes); 4096 pairs of 256-base
              sequences (warp body), one 1500 x 1500 pair and one
              random 12000 x 16000 pair past PR 14's shared-memory cap
              (bands body), each call on the body its rule or plan
              names; a 30000 x 30000 pair of identical sequences
              against its closed-form score (match x 30000); a
              2**24-float ring; 2**26 values in
              1024 to 65536 bins (past 32768 only the DSM histogram
              fits a block), each at cluster sizes 1 (no DSM), 2, 4, 8
              and 16 (non-portable), the ring also at ILP 8 and in int32
              with sums that wrap.  Kernel ms, plain ms, bound (int32
              instructions over SMs x 64 lanes x the maximum SM clock,
              or bytes over 3.35 TB/s) and a one-call PyTorch yardstick
              (torch.bincount, torch.roll, a permuting copy); the DPX
              opcodes in the SASS of each kernel of the built library
              (the redesigned kernels must hold VIADDMNMX) and the DPX
              rate probe (csrc/dpx_rate_probe.cu: intrinsic against
              plain C with operands in registers, a finding); then the
              dpx_functions, dpx_kernels and dsm benchmarks through the
              kernels, with tropical_matmul's and smith_waterman's
              launches by body.
 10. train  — (a) the flash-attention forward (flash_attention, B9)
              against its plain version (the blockwise forward in torch
              ops), o and lse, on the reference's kernel-test cases,
              yi-6b's full-width training shape (B=2, S=4096, H=32,
              KH=4, hd=128, bf16, causal), llama-te-mini's heads, a
              window, a ragged S, q_offset > 0 with Sq < Sk, rows with
              no valid key (float32 and bf16) and head_dim 80 (bf16 and
              float32), each on the body its rule names (wgmma for bf16
              at hd 64 / 128, mma_sync for bf16 at other hd, fma for
              float32), held to the source's rule and the per-body
              count: kernel ms, plain ms, the ms of
              scaled_dot_product_attention (a yardstick the port never
              calls), the bound and TFLOP/s; (b) dq, dk, dv with the kernel
              forward against the plain forward at the full-width
              shape; (c) one training step of full-width yi-6b with its
              depth cut to 8 layers (fp32 parameters, gradients and
              AdamW moments take 16 bytes a parameter: 32 layers need
              97 GB, 8 layers 30.5 GB), remat dots, B=2 x 4096 tokens,
              every flash call held against its plain version; (d)
              Trainer.run on that configuration: finite, falling
              losses, step ms, tokens/s, peak memory, B9 launches per
              step, all on its wgmma body; (e) the reduced yi-6b on the
              card: a run that fails
              and restarts from its checkpoint gives the losses of an
              uninterrupted run bit for bit.
 11. memory_te — (a) the memory-hierarchy kernels (csrc/memory.cu)
              against their plain versions, exactly: the pointer chase's
              last index against the host walk's at every Table IV level
              (L1 .ca 16 KB, shared 16 KB, L2 .cg 8 MB, device memory .cg
              1 GB, on the reference's chain) and along the classic .cg
              sweep from 4 KB to 1 GB by doubling (chains made on the
              card; a level row past L1 within 10% of the sweep at its
              size), cycles and %globaltimer ns a hop; the stream
              y = 2x + 1 bitwise (8 MB x 256 passes from L2, 2 GB from
              device memory) against torch.add's one call; one block an
              SM reading 16 KB from shared memory and from L1, checksums
              exact, bytes a clock an SM; each with its ms, plain ms and
              bound; (b) te_linear and its backward on the card against
              the port on the CPU on the same inputs, parameters, state
              and cotangent at 66 tokens (not a multiple of 16), 256 ->
              512: e4m3 and e5m2 codes and new states bitwise, y, dx, dw
              within the stated limits; Fig. 4's sweep (N 256 to 16384,
              bf16 against fp8 GFLOP/s, back to back and as a CUDA-graph
              replay, the crossover) and one profiler pass of te_linear
              at N=512 and 16384; (c) te_transformer_layer at Table II's
              five hidden sizes, B=4, S=512: finite, histories rolled, B9
              launched once a call on its wgmma body under sync debug
              mode "error", its latency against layer_fwd's in bf16
              (Fig. 5); then the memory_latency, memory_throughput,
              te_linear and te_layer benchmarks through the kernels.
 12. families — the moe and vlm families (models/moe.py): (a)
              moonshot-v1-16b-a3b at full width, its depth cut to 3
              of 48 layers to keep the script inside its time limit (d
              2048, 64 experts top-6, vocab 163840, random bf16
              weights, seed 0; yi-6b freed first): phase 4's
              forward check (bf16 and an e4m3 pool), phase 5's waves in
              bf16 and with an e4m3 pool (bf16 linears: moe refuses
              fp8 linears) through graphs captured once, equal bit for
              bit to a fresh eager server, a K=4 spec wave cold and warm
              (acceptance printed, not held: a moe call couples its
              rows), phase 6's profile of the units, tokens/s, peak
              memory and the decode step's device ms against its bytes
              bound (every weight read once, KV); (b) internvl2-1b at
              full width, 12 of its 24 layers (G=7, hd 64, tied
              embeddings): the forward check and phase 5's waves; (c)
              reduced moonshot, dbrx and internvl2-1b card against CPU
              by phase 7's rules
              (bf16; a moe call couples its rows, so only the first
              parting step is held), and one full-width moonshot
              moe_mlp call (T=128) card against CPU; (d) moonshot at
              full width cut to 2 layers and internvl2-1b at full depth
              (B=2, S=2048, prefix_embeds): phase 10's checked train
              step and Trainer.run on fresh batches (moonshot: the mean
              loss of its own batches must fall; internvl2-1b's printed).
 13. ssm    — the ssm and hybrid families (models/ssm.py, ssm_lm.py,
              hybrid.py): (a) falcon-mamba-7b at full width and depth
              (64 layers, d 4096, d_inner 8192, N 16, vocab 65024, 7.27
              B random bf16 weights, seed 0): api.prefill on B=8 x 512
              equal bit for bit to ssm_lm.forward + logits_fn at the
              last position; the prompt's last 16 tokens decoded one by
              one from the state after the rest, the first step within
              SSM_TAIL_STEPS bf16 steps of the forward's row (the rest
              and the stack's own bf16 noise printed: the random stack
              is chaotic); the decode step as a runtime.graphs.WorkUnit
              (eager, then one CUDA graph), equal bit for bit to an
              eager step, and 64 greedy steps through its replays;
              prefill ms and tokens/s, the eager step's wall ms, the
              replay's device ms against its bytes bound, its kernels
              by kind, peak memory; (b) zamba2-2.7b at full width and
              depth (54 layers = 9 super-blocks of 6, H = KH = 32, hd
              80): api.prefill (the forward) with each of its 9 B9
              calls (mma_sync) held to plain, the prompt fed token by
              token from state zero and 32 greedy steps through the
              decode step's graph, the same numbers; (c) the reduced
              falcon-mamba-7b and zamba2-2.7b card against CPU (tokens
              by phase 7's margin rule, logits within max(4, 3 x the
              CPU's own bf16-vs-float32 distance) bf16 steps); (d)
              falcon-mamba-7b cut to 2 layers and zamba2-2.7b to 6 (1
              super-block), B=2 x 2048: phase 10's checked train step
              and Trainer.run on fresh batches (the mean loss of the
              run's own batches must fall).
 14. encdec — the encoder-decoder family (models/encdec.py):
              full-width whisper-small (12 + 12 layers, d 768, H = KH =
              12, hd 64, vocab 51865; 0.24 B random bf16 weights, seed
              0) on B=8 random bf16 30-second windows of 1500 x 768
              frames (api.make_batch): (a) B9 at its encoder (1500 x
              1500, non-causal, a ragged last key tile) and
              cross-attention (448 x 1500) shapes runs in phase 10(a)'s
              cases (whisper-enc, whisper-cross); (b) api.prefill with
              every B9 call held to its plain version, 12 launches on
              wgmma, prefill ms and frames/s; (c) the decode step as a
              runtime.graphs.WorkUnit (one CUDA graph), greedy from the
              start-of-transcript token to max_target_len (447 steps),
              the first 16 steps' logits equal an eager run's bit for
              bit, the replay's device ms with the cache full against
              its bytes bound, its kernels a step, the eager wall ms;
              (d) loss_fn and its backward (float32 parameters, remat
              dots) on a B=2 batch of 1500 frames and 448 tokens: every
              B9 call checked, 72 launches on wgmma, loss and gradient
              norm finite, B9's dq/dk/dv at the step's encoder, decoder
              and cross shapes with the kernel forward within phase
              10's bar of the plain forward's, step ms and peak memory,
              apply_ef(int8_ef) of the gradients on the card bit for bit
              the CPU's; (e) the reduced whisper-small card against CPU
              (phase 13(c)'s rule).
 15. tp     — tensor-parallel serving (runs after phase 5e, on phase
              4-6's full-width yi-6b at SERVE_LAYERS): ChunkedServer on a
              mesh of tp positions spread over the card
              (make_tp_mesh(tp, spread="cuda"): each position its own
              weight shards and dense pools of KH/tp heads, one CUDA
              graph a work unit across the shards): tp = 1, 2, 4 on one
              system-prompt wave (12 requests, prefix cache and
              copy-on-write, spec decode K=4), then tp=2 with an e4m3
              pool and sampled (no spec: spans too) against tp=1.  Each
              stream equals tp=1's, or the first parting step is held
              to tp=1's margin; each unit one program, captured once;
              tp=2's graphs equal its eager units bit for bit; the
              paged kernels launched tp x L a step (and as many on the
              card); each position's pool 1/tp of tp=1's bytes.
              Tokens/s and the verify and span steps' device ms at each
              tp are printed, a record.  Phase 2b also serves the
              reference's tp combos (--spread 2), and phase 3 times the
              paged kernels at the shards' heads (KH 2 and 1, G=8).
 16. train_sharded — the sharded training step (runs after phase 10)
              on a ("data", "model") = (2, 4) mesh spread over the card
              (make_host_mesh((2, 4), spread="cuda")), plan fsdp_tp,
              random weights, seed 0: (a) full-width yi-6b cut to 1
              layer (remat dots, float32 parameters, bf16), B=2 x 4096:
              the step's loss within 7e-3 of the one-device step's on
              the same weights and batch, each gathered gradient leaf
              within 5% of its norm, the grad norms printed side by
              side; B9 launched 8 positions x (forward + remat
              recompute) at the shards' shape [1, 4096, 8, 128] over 1
              kv head on wgmma (the wrapper's launches by shape), each
              call held to its plain version; phase 10(a) times B9 at
              that shape (yi-6b-fsdp-tp-shard); (b) the same cut to 2
              layers: Trainer(mesh=, plan=) for 3 steps twice from one
              start (bit for bit equal, finite, falling), then the
              one-device Trainer from that start: step ms, tokens/s,
              peak memory, B9 launches and one profiled step's device
              ms by kind of both printed, a record;
              (c) reduced yi-6b and internvl2-1b under dp, fsdp, tp,
              fsdp_tp and fsdp_tp_spact, 3 Trainer steps on the card
              mesh against the same on a mesh spread over the CPU
              (first loss within 2e-3, all within 1e-2).
 17. train_sharded_families — the other families' sharded training
              step (runs after phase 16, on its mesh and plan, random
              weights, seed 0): (a) moonshot-v1-16b-a3b (1 of 48
              layers: 16 experts a position, C = 480 at T = 4096),
              falcon-mamba-7b (1 of 64 layers: 2048 channels a
              position), zamba2-2.7b (one Mamba-2 layer and the shared
              block: 20 SSM heads, 8 attention heads at hd 80 a
              position) and whisper-small (1 + 1 of 12 + 12 layers,
              1500 frames, 448 tokens: 3 heads a position) at full
              width, float32 parameters, bf16 activations, remat dots,
              B=2 x 2048: the fsdp_tp step against the one-device step
              on the same weights and batch: the loss within 7e-3
              (zamba2: 1.5 x the reference's own reduced distance),
              each gathered gradient leaf within 5% of its norm
              (zamba2: 1.5 x the smallest leaf distance of the
              reference's own reduced steps); with float32 activations
              the loss within 1e-5 relative and every leaf within 1e-4
              of its max |g| or 1.5 x its rounding floor (the CPU
              tests' rule); B9 launched 8 positions x (forward +
              remat recompute) a call site at each family's shard shape
              (one device: 1 position), each call held to its plain
              version; moonshot's expert ids and drops,
              sharded against one device, printed (at most 1% parted,
              each a near tie); grad norms, step ms and peak memory
              side by side; phase 10(a) times B9 at those shapes; (b)
              the reduced families (moonshot also under tp with
              n_micro=2) card mesh against CPU mesh, phase 16(c)'s bars
              (all steps held where neither host's bf16 run lies 1e-2
              from its float32 run), and with float32 rows (the first
              loss within 1e-5 relative, all within 5e-4).
Each serve phase, the benchmark runs of phases 8, 9 and 11, the
Trainer.run of phases 10, 12, 13 and 16(b), phase 13's prefill, phase
14's prefill and training step, phase 16(a)'s and phase 17(a)'s
sharded steps set
their kernels' launch counts to 0 just before their main path and read
them just after; phase 5b reads the
paged kernels' counts (set to 0) after each spec wave, and its
launches join phase 5's in paged_chunk's and paged_chunk_fp8's counts,
and phase 5e's join all four paged kernels' counts; phases 5, 5b and
5e also read the counts around every work unit's dispatch, which gives
the paged kernels' launches by work unit (chunk, span, verify); each
phase 15 wave sets them to 0 before it and reads them after, and its
launches join all four paged kernels' counts.  Then one JSON line of
per-kernel numbers (twenty kernels; those with several bodies also
their launches by body, flash_attention its launches by path: Trainer,
te_layer, phase 12's Trainer, phase 13's prefill and Trainer, phase
14's prefill and training step, phase 16's and phase 17's sharded
steps, and its whisper-enc, whisper-cross and fsdp_tp shard readings;
the
paged kernels phase 12's and phase 15's launches apart too, and
their readings at the tp shards' heads) and, last, the contract
line
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12                       # H100 SXM data sheet
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# float32 pools: the kernel and the plain version sum in another order,
# a few float32 roundings of outputs of magnitude ~1
F32_LIMIT = 2e-5
# bf16 pools: p and the output are rounded to bf16, and a value on a
# rounding boundary may round the other way: one bf16 step at |o| < 4,
# and one bf16 step (2**-7) of its row's max |o|, which at long contexts
# is small (|o| ~ 0.01 at 32768 positions)
BF16_LIMIT = 2e-2
BF16_ROW_STEP = 2.0 ** -7
# a kernel call of the full-width forward against its plain version on
# the same inputs: two bf16 steps (2**-6) of the output's magnitude
ATTN_REL_LIMIT = 2.0 ** -6
# small-input serving, card vs CPU: logits differ by a bf16 step or so
# (cuBLAS and the CPU round differently); streams may part where the
# top-2 margin is within four bf16 steps at |logit| < 4
SMALL_MARGIN = 0.0625
# the same with an e4m3 pool and fp8 linears: e4m3 turns a one-step
# bf16 difference into a one-step e4m3 difference (16x larger), and a
# per-tensor activation scale moves with a one-step change of its max
# (tests/test_torch_server.py, FP8_MARGIN)
SMALL_FP8_MARGIN = 0.5
DEVICE = "cuda"
SERVE_SPAN = 8          # phase 5's decode steps a span dispatch
# the serving depth of phases 4-6 and 15: yi-6b at full width, 8 of its
# 32 layers, so that the script with phases 12, 13 and 16 ends near 600
# s, half its 1200 s (every count and bound below follows
# cfg.num_layers)
SERVE_LAYERS = 8


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


# ----------------------------------------------------------------------
# 1-2. card and build
# ----------------------------------------------------------------------

def phase_card() -> dict:
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: chip_smoke.py needs one GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    """Every source of kernels/csrc, one nvcc each, all started
    together; ptxas registers, shared memory, spills and its warnings of
    serialized wgmma ("Performance Loss") printed."""
    from concurrent.futures import ThreadPoolExecutor
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    sources = sorted(build.SIGNATURES)
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(
            lambda src: build.compile_source(src, ptxas_verbose=True),
            sources))
    for src, (path, secs, log) in zip(sources, built):
        print(f"[build] {os.path.relpath(path, ROOT)} "
              f"{'built in %.1f s' % secs if secs else 'already built'}")
        for line in log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line
                                    or "Compiling" in line
                                    or "Performance Loss" in line):
                print(f"[build]   {line.strip()}")
        build.load(src)
    print(f"[build] {len(sources)} sources loaded in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def phase_analysis() -> dict:
    """The serving-contract analyzer on the card, in process and strict:
    all three layers; fails on any finding, on an AST scan that reached
    fewer than 60 functions from the unit bodies, on a unit of a combo
    that is not one program and one capture, or on a planned launch that
    no real launch matched.  The kernels' launch counts are set back to 0
    after it (later phases count their own paths)."""
    import gc
    import tempfile
    import torch
    from repro_torch.analysis.__main__ import main as analyze
    from repro_torch.analysis import contracts
    from repro_torch.kernels import (async_pipeline, dpx_kernel,
                                     flash_attention, fp8_matmul, matmul,
                                     paged_attention)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as td:
        path = os.path.join(td, "analysis_report.json")
        rc = analyze(["--strict", "--repo-root", ROOT, "--report", path,
                      "--spread", "2"])
        with open(path) as fh:
            rep = json.load(fh)
    secs = time.perf_counter() - t0
    layer = {"AST": 0, "KL": 0, "JX": 0}
    for f in rep["findings"]:
        layer[f["rule"].rstrip("0123456789")] += 1
    units = rep["graph_units"]
    combos = {u["combo"] for u in units}
    planned = len(rep["kernel_launches"])
    matched = rep["kernel_launches_matched"]
    captures = sum(u["captures"] for u in units)
    hot = rep["ast_hot_functions"]
    print(f"[analysis] findings by layer: ast {layer['AST']} over {hot} "
          f"hot functions, kernel "
          f"{layer['KL']}, graph {layer['JX']} (exit code {rc}, "
          f"{len(rep['suppressed'])} suppressed); {len(units)} units x "
          f"combos over {len(combos)} combos, {captures} captures, "
          f"calls {sum(u['calls'] for u in units)}; launches planned "
          f"{planned}, matched {matched}; layer seconds "
          f"{ {k: round(v, 2) for k, v in rep['layer_seconds'].items()} }; "
          f"phase {secs:.1f} s", flush=True)
    for u in units:
        if u.get("paged_launches"):
            print(f"[analysis]   {u['unit']} [{u['combo']}]: calls "
                  f"{u['calls']}, programs {u['programs']}, captures "
                  f"{u['captures']}, graph launches {u['paged_launches']}")
    if rc != 0 or rep["findings"]:
        fail(f"the analyzer found {len(rep['findings'])} finding(s): "
             f"{rep['summary']}")
    if hot < 60:
        fail(f"the AST layer reached {hot} functions from the unit bodies")
    bad = [u for u in units if u["programs"] != 1 or u["captures"] != 1]
    if bad:
        fail(f"units not one program and one capture: {bad}")
    if len(combos) != len(contracts.serving_combos(device_count=2)):
        fail(f"the graph layer checked {len(combos)} combos")
    if planned != matched or planned < 13:
        fail(f"{matched} of {planned} planned launches matched")
    for mod in (async_pipeline, dpx_kernel, flash_attention, fp8_matmul,
                matmul, paged_attention):
        mod.reset_launch_counts()
    gc.collect()
    torch.cuda.empty_cache()
    return {"seconds": secs, "units": len(units), "combos": len(combos),
            "captures": captures, "planned": planned, "matched": matched}


# ----------------------------------------------------------------------
# 3. kernels against their plain versions
# ----------------------------------------------------------------------

def _time_ms(fn, iters: int, warm: int = 3) -> float:
    import torch
    for _ in range(warm):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _graph_ms(fn, iters: int) -> float:
    """Device ms of one call: `iters` calls captured in a CUDA graph and
    replayed once (no host time between launches)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _case_inputs(dtype, B, H, KH, hd, bs, MB, C, seed, full=False):
    """Pool, block table with -1 tails, ragged lengths up to MB*bs (with
    `full`, every slot within bs of MB*bs)."""
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    T = MB * bs
    NB = B * MB + 8
    if full:
        kv = T - torch.randint(0, bs, (B,), generator=g, device=DEVICE)
        kv = kv.to(torch.int32)
    else:
        kv = torch.tensor([T - 8, 1, 17, 100, T - 17, 33, 128, 200][:B],
                          dtype=torch.int32, device=DEVICE).clamp(1, T)
    ck = torch.randn((NB, bs, KH, hd), generator=g, device=DEVICE).to(dtype)
    cv = torch.randn((NB, bs, KH, hd), generator=g, device=DEVICE).to(dtype)
    bt = torch.randperm(NB, generator=g, device=DEVICE)[:B * MB]
    bt = bt.reshape(B, MB).to(torch.int32)
    nblk = (kv + bs - 1) // bs
    col = torch.arange(MB, device=DEVICE)[None, :]
    bt = torch.where(col < nblk[:, None], bt, torch.full_like(bt, -1))
    qd = torch.randn((B, 1, H, hd), generator=g, device=DEVICE).to(dtype)
    qc = torch.randn((B, C, H, hd), generator=g, device=DEVICE).to(dtype)
    pos = (kv - C).clamp(min=0)
    return qd, qc, ck, cv, bt, kv, pos


def _bound(kind, dtype_name, B, H, KH, hd, C, MB, bs, lens, q_elt,
           kv_elt, scale_bytes=0, kv_reads=1.0):
    """Least time for the work: each input byte read once (q, the K/V
    rows the rows attend at `kv_elt` bytes an element plus
    `scale_bytes` per (token, kv head) row of K and of V, table,
    lengths), output written once; 4*hd operations per (query head,
    attended position) at the peak rate of q's dtype.  `kv_reads` 1.5
    gives instead the bytes a body that reads K twice and V once
    moves."""
    lens = [int(x) for x in lens]
    T = MB * bs
    if kind == "decode":
        tokens = [min(n, T) for n in lens]
        pairs = sum(tokens)
        rows = 1
    else:
        tokens = [min(p + C, T) for p in lens]
        pairs = sum(min(p + 1 + i, T) for p in lens for i in range(C))
        rows = C
    kv_bytes = kv_reads * 2 * sum(tokens) * KH * (hd * kv_elt + scale_bytes)
    qo_bytes = 2 * B * rows * H * hd * q_elt
    nbytes = kv_bytes + qo_bytes + 4 * B * (MB + 1)
    ops = 4 * hd * H * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_inputs(q, kg, vg, bound_rows):
    """Gathered view for scaled_dot_product_attention: q [B,H,R,hd],
    k/v [B,T,KH,hd] repeated to H heads [B,H,T,hd], boolean mask
    [B,1,R,T]."""
    import torch
    H, KH = q.shape[2], kg.shape[2]
    k = kg.transpose(1, 2).repeat_interleave(H // KH, dim=1).contiguous()
    v = vg.transpose(1, 2).repeat_interleave(H // KH, dim=1).contiguous()
    T = k.shape[2]
    mask = (torch.arange(T, device=q.device)[None, None, None, :]
            < bound_rows[:, None, :, None])
    return q.transpose(1, 2).contiguous(), k, v, mask


# phase 3 cases: name, q dtype, B, H, KH, hd, bs, MB, every slot full.
# yi-6b's serving shape (max_len 264 at bs 16: 17 table entries), and
# its decode_32k shape (configs/base.py SHAPES: 32768 positions, every
# slot within bs of them; bf16 only); llama-te-mini's heads; zamba2-2.7b's
# attention (hd 80, 32 heads over 32 kv heads).
PAGED_CASES = [
    ("yi-6b", "bfloat16", 8, 32, 4, 128, 16, 17, False),
    ("yi-6b", "float32", 8, 32, 4, 128, 16, 17, False),
    ("llama-te-mini", "bfloat16", 8, 12, 12, 64, 16, 17, False),
    ("llama-te-mini", "float32", 8, 12, 12, 64, 16, 17, False),
    ("zamba2-2.7b", "bfloat16", 8, 32, 32, 80, 16, 17, False),
    ("zamba2-2.7b", "float32", 8, 32, 32, 80, 16, 17, False),
    ("yi-6b decode_32k", "bfloat16", 8, 32, 4, 128, 16, 2048, True),
    # phase 12's families: moonshot-v1-16b-a3b (G=1, hd 128) and
    # internvl2-1b (G=7, hd 64: 7 / 112 query rows a kv head)
    ("moonshot-v1-16b-a3b", "bfloat16", 8, 16, 16, 128, 16, 17, False),
    ("moonshot-v1-16b-a3b", "float32", 8, 16, 16, 128, 16, 17, False),
    ("internvl2-1b", "bfloat16", 8, 14, 2, 64, 16, 17, False),
    ("internvl2-1b", "float32", 8, 14, 2, 64, 16, 17, False),
    # phase 15's shards of yi-6b: tp=2 holds 16 heads over 2 kv heads,
    # tp=4 8 over 1 (G=8 both)
    ("yi-6b tp=2 shard", "bfloat16", 8, 16, 2, 128, 16, 17, False),
    ("yi-6b tp=4 shard", "bfloat16", 8, 8, 1, 128, 16, 17, False),
]
# float32 elements of the plain version's [B,KH,G,C,T,hd] product above
# which it runs slot by slot (the decode_32k chunk's would take 69 GB)
PLAIN_SLOT_ELEMENTS = 2 ** 31


def phase_kernels() -> dict:
    """Results keyed (kernel name, case name, q dtype).  Every call runs
    on the body and plan its rule names and is counted there once."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import attention
    from repro_torch.te import fp8
    C = 16
    results = {}
    for i, (name, dname, B, H, KH, hd, bs, MB, full) in enumerate(
            PAGED_CASES):
        dtype = getattr(torch, dname)
        qd, qc, ck, cv, bt, kv, pos = _case_inputs(dtype, B, H, KH, hd, bs,
                                                   MB, C, seed=i, full=full)
        # e4m3 pools: the same rows, quantized per (token, kv head) row
        kq, ks = fp8.quantize_rowwise(ck.float())
        vq, vs = fp8.quantize_rowwise(cv.float())
        limit = BF16_LIMIT if dtype == torch.bfloat16 else F32_LIMIT
        ar = torch.arange(C, device=DEVICE, dtype=torch.int32)
        long_case = MB * bs > 4096
        for kernel in ("paged_decode", "paged_chunk", "paged_decode_fp8",
                       "paged_chunk_fp8"):
            decode = kernel.startswith("paged_decode")
            q, lens = (qd, kv) if decode else (qc, pos)
            rows_bound = (lens[:, None] if decode
                          else lens[:, None] + 1 + ar[None, :])
            if kernel.endswith("fp8"):
                args = (q, kq, vq, bt, lens)
                kw = dict(k_scale=ks, v_scale=vs)
                kv_elt, scale_bytes = 1, 4
            else:
                args, kw = (q, ck, cv, bt, lens), {}
                kv_elt, scale_bytes = ck.element_size(), 0
            fn = getattr(pk, kernel)
            plain_fn = getattr(pk, kernel + "_plain")
            plan = pk.plan(dtype, hd, B, KH, H // KH, q.shape[1], MB * bs)
            kern = lambda: fn(*args, **kw)
            n0 = dict(fn.body_launches)
            got = kern()
            torch.cuda.synchronize()
            counted = {b: fn.body_launches[b] - n0[b] for b in n0}
            if counted != {b: int(b == plan.body) for b in n0}:
                fail(f"{kernel} {name} {dname}: launch counted {counted}, "
                     f"not once on {plan.body}")
            if not torch.isfinite(got.float()).all():
                fail(f"{kernel} {name} {dname}: non-finite kernel output")
            slots = (B if B * H * q.shape[1] * MB * bs * hd
                     > PLAIN_SLOT_ELEMENTS else 1)
            step = B // slots

            def plain():
                outs = [plain_fn(q[b:b + step], *args[1:3], bt[b:b + step],
                                 lens[b:b + step], **kw)
                        for b in range(0, B, step)]
                return torch.cat(outs) if len(outs) > 1 else outs[0]
            want = plain().float()
            diff = (got.float() - want).abs()
            err = diff.max().item()
            row_limit = torch.full_like(want[..., :1], limit)
            if dtype == torch.bfloat16:
                row_limit = row_limit.minimum(
                    BF16_ROW_STEP * want.abs().amax(-1, keepdim=True))
            ok = bool((diff <= row_limit).all())
            rel = ("" if dtype != torch.bfloat16 else
                   f" and 2**-7 of its row's max |o|, tightest "
                   f"{row_limit.min().item():.3e}")
            del want, diff, row_limit
            iters = 10 if long_case else 200
            ms = _time_ms(kern, iters)
            dev_ms = _graph_ms(kern, 5 if long_case else 20)
            plain_ms = _time_ms(plain, 1 if long_case else 10,
                                warm=1 if long_case else 3)
            if kernel.endswith("fp8"):
                kg, vg = attention.gather_paged_cache_fp8(
                    {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}, bt,
                    out_dtype=dtype)
            else:
                kg, vg = attention.gather_paged_cache(ck, cv, bt)
            sq, sk, sv, mask = _sdpa_inputs(q, kg, vg, rows_bound)
            del kg, vg
            sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                          attn_mask=mask)
            lib_ms = _time_ms(sdpa, 5 if long_case else 50)
            lib_dev_ms = _graph_ms(sdpa, 5 if long_case else 20)
            del sq, sk, sv, mask
            bound_ms, bound_by = _bound(
                "decode" if decode else "chunk", dname, B, H, KH, hd, C, MB,
                bs, lens.tolist(), q.element_size(), kv_elt, scale_bytes)
            print(f"[kernels] {kernel} {name} q {dname} B={B} H={H} "
                  f"KH={KH} hd={hd} bs={bs} MB={MB}"
                  f"{'' if decode else ' C=%d' % C}: body {plan.body}, "
                  f"plan splits={plan.splits} rows={plan.rows} "
                  f"groups={plan.groups} split_len={plan.split_len} "
                  f"smem={plan.smem}; max_abs_err={err:.3e} (limit "
                  f"{limit:.0e}{rel}"
                  f"{', plain slot by slot' if slots > 1 else ''}"
                  f") ms={ms:.4f} device_ms={dev_ms:.4f} "
                  f"plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
                  f"sdpa_device_ms={lib_dev_ms:.4f} bound_ms={bound_ms:.5f}"
                  f" ({bound_by}; device/bound {dev_ms / bound_ms:.2f}) "
                  f"{'ok' if ok else 'OVER LIMIT'}", flush=True)
            if not ok:
                fail(f"{kernel} {name} {dname}: max abs error {err}, "
                     f"over {limit}{rel}")
            results[(kernel, name, dname)] = {
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "library_device_ms": lib_dev_ms}
        del qd, qc, ck, cv, bt, kq, vq, ks, vs
        torch.cuda.empty_cache()
    return results


# the verify work unit's shape: spec decode K=4 scores C = K + 1 rows a
# slot (40 query rows a kv head at yi-6b's G=8); B=8 slots, 128 cached
# tokens each, as phase 6 profiles
VERIFY_K = 4
VERIFY_CASE = ("yi-6b verify", "bfloat16", 8, 32, 4, 128, 16, 17)
# the same at phase 15's shard heads
VERIFY_CASES = [VERIFY_CASE,
                ("yi-6b tp=2 shard verify", "bfloat16", 8, 16, 2, 128, 16,
                 17),
                ("yi-6b tp=4 shard verify", "bfloat16", 8, 8, 1, 128, 16,
                 17)]


def phase_verify_kernels(results: dict) -> None:
    """paged_chunk and paged_chunk_fp8 at the verify shape (yi-6b's
    heads and each tp shard's) against their plain versions, with
    CUDA-event and graph-replay ms, the byte bound and SDPA over the
    gathered view; added to `results` under the case name."""
    for case in VERIFY_CASES:
        _verify_kernels(results, case)


def _verify_kernels(results: dict, case) -> None:
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import attention
    from repro_torch.te import fp8
    name, dname, B, H, KH, hd, bs, MB = case
    dtype = getattr(torch, dname)
    C = VERIFY_K + 1
    g = torch.Generator(device=DEVICE).manual_seed(31)
    NB = B * MB
    ck = torch.randn((NB, bs, KH, hd), generator=g, device=DEVICE).to(dtype)
    cv = torch.randn((NB, bs, KH, hd), generator=g, device=DEVICE).to(dtype)
    bt = torch.randperm(NB, generator=g, device=DEVICE).reshape(B, MB)
    bt = bt.to(torch.int32)
    q = torch.randn((B, C, H, hd), generator=g, device=DEVICE).to(dtype)
    pos = torch.full((B,), 128, dtype=torch.int32, device=DEVICE)
    kq, ks = fp8.quantize_rowwise(ck.float())
    vq, vs = fp8.quantize_rowwise(cv.float())
    rows_bound = pos[:, None] + 1 + torch.arange(C, device=DEVICE)[None, :]
    for kernel in ("paged_chunk", "paged_chunk_fp8"):
        is_fp8 = kernel.endswith("fp8")
        args = (q, kq, vq, bt, pos) if is_fp8 else (q, ck, cv, bt, pos)
        kw = dict(k_scale=ks, v_scale=vs) if is_fp8 else {}
        fn, plain_fn = getattr(pk, kernel), getattr(pk, kernel + "_plain")
        plan = pk.plan(dtype, hd, B, KH, H // KH, C, MB * bs)
        kern = lambda: fn(*args, **kw)
        n0 = dict(fn.body_launches)
        got = kern()
        torch.cuda.synchronize()
        counted = {b: fn.body_launches[b] - n0[b] for b in n0}
        if counted != {b: int(b == plan.body) for b in n0}:
            fail(f"{kernel} {name}: launch counted {counted}, not once on "
                 f"{plan.body}")
        want = plain_fn(*args, **kw).float()
        diff = (got.float() - want).abs()
        err = diff.max().item()
        row_limit = torch.full_like(want[..., :1], BF16_LIMIT).minimum(
            BF16_ROW_STEP * want.abs().amax(-1, keepdim=True))
        ok = bool((diff <= row_limit).all()) and bool(
            torch.isfinite(got.float()).all())
        ms = _time_ms(kern, 200)
        dev_ms = _graph_ms(kern, 20)
        plain_ms = _time_ms(lambda: plain_fn(*args, **kw), 10)
        if is_fp8:
            kg, vg = attention.gather_paged_cache_fp8(
                {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}, bt,
                out_dtype=dtype)
        else:
            kg, vg = attention.gather_paged_cache(ck, cv, bt)
        sq, sk, sv, mask = _sdpa_inputs(q, kg, vg, rows_bound)
        sdpa = lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                      attn_mask=mask)
        lib_ms = _time_ms(sdpa, 50)
        lib_dev_ms = _graph_ms(sdpa, 20)
        bound_ms, bound_by = _bound(
            "chunk", dname, B, H, KH, hd, C, MB, bs, pos.tolist(),
            q.element_size(), 1 if is_fp8 else 2, 4 if is_fp8 else 0)
        print(f"[kernels] {kernel} {name} q {dname} B={B} H={H} KH={KH} "
              f"hd={hd} bs={bs} MB={MB} C={C} (K={VERIFY_K}), 128 cached "
              f"tokens a slot: body {plan.body}, plan splits={plan.splits} "
              f"rows={plan.rows} groups={plan.groups} split_len="
              f"{plan.split_len} smem={plan.smem}; max_abs_err={err:.3e} "
              f"(limit {BF16_LIMIT:.0e} and 2**-7 of its row's max |o|) "
              f"ms={ms:.4f} device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} "
              f"sdpa_ms={lib_ms:.4f} sdpa_device_ms={lib_dev_ms:.4f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}; device/bound "
              f"{dev_ms / bound_ms:.2f}) {'ok' if ok else 'OVER LIMIT'}",
              flush=True)
        if not ok:
            fail(f"{kernel} {name}: max abs error {err} over the limit")
        results[(kernel, name, dname)] = {
            "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms,
            "library_device_ms": lib_dev_ms}
        del sq, sk, sv, mask, kg, vg


# yi-6b's attention heads past the held scores (~80k positions at bf16
# hd 128, 46080 at float32): every slot at T positions, decode at B=2
# and a 16-row chunk at B=1, on the plan that recomputes the scores;
# bf16 q over bf16 and e4m3 pools at 131072, float32 q at 65536
LONG_CASES = [
    ("yi-6b 128k", "bfloat16", 131072,
     ("paged_decode", "paged_chunk", "paged_decode_fp8", "paged_chunk_fp8")),
    ("yi-6b 64k", "float32", 65536, ("paged_decode", "paged_chunk")),
]


def phase_long_kernels(results: dict) -> None:
    """The paged kernels past the held scores against their plain
    versions (the chunk's row by row: its [C, T, hd] product would not
    fit), each call on the recompute plan its rule names and counted
    there once; CUDA-event and graph-replay ms, plain ms, SDPA over the
    gathered view, the bound (inputs read once) and the time of the
    bytes the body reads (K twice, V once); added to `results` under
    the case name."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import attention
    from repro_torch.te import fp8
    H, KH, hd, bs = 32, 4, 128, 16
    for name, dname, T, kernels in LONG_CASES:
        dtype = getattr(torch, dname)
        limit = BF16_LIMIT if dtype == torch.bfloat16 else F32_LIMIT
        MB = T // bs
        for kernel in kernels:
            decode = kernel.startswith("paged_decode")
            is_fp8 = kernel.endswith("fp8")
            B, C = (2, 1) if decode else (1, 16)
            g = torch.Generator(device=DEVICE).manual_seed(T + C)
            NB = B * MB
            ck = torch.randn((NB, bs, KH, hd), generator=g,
                             device=DEVICE).to(dtype)
            cv = torch.randn((NB, bs, KH, hd), generator=g,
                             device=DEVICE).to(dtype)
            bt = torch.randperm(NB, generator=g, device=DEVICE).reshape(
                B, MB).to(torch.int32)
            q = torch.randn((B, C, H, hd), generator=g,
                            device=DEVICE).to(dtype)
            lens = torch.full((B,), T if decode else T - C,
                              dtype=torch.int32, device=DEVICE)
            kw = {}
            if is_fp8:
                ck, ks = fp8.quantize_rowwise(ck.float())
                cv, vs = fp8.quantize_rowwise(cv.float())
                kw = dict(k_scale=ks, v_scale=vs)
            fn, plain_fn = getattr(pk, kernel), getattr(pk, kernel + "_plain")
            plan = pk.plan(dtype, hd, B, KH, H // KH, C, T)
            kern = lambda: fn(q, ck, cv, bt, lens, **kw)  # noqa: E731

            def plain():
                if decode:
                    return plain_fn(q, ck, cv, bt, lens, **kw)
                return torch.cat([plain_fn(q[:, c:c + 1].contiguous(), ck,
                                           cv, bt, lens + c, **kw)
                                  for c in range(C)], 1)
            n0 = dict(fn.body_launches)
            got = kern()
            torch.cuda.synchronize()
            counted = {b: fn.body_launches[b] - n0[b] for b in n0}
            if not plan.recompute or counted != {
                    b: int(b == plan.body) for b in n0}:
                fail(f"{kernel} {name}: plan {plan}, launch counted "
                     f"{counted}")
            want = plain().float()
            diff = (got.float() - want).abs()
            err = diff.max().item()
            row_limit = torch.full_like(want[..., :1], limit)
            if dtype == torch.bfloat16:
                row_limit = row_limit.minimum(
                    BF16_ROW_STEP * want.abs().amax(-1, keepdim=True))
            ok = bool((diff <= row_limit).all()) and bool(
                torch.isfinite(got.float()).all())
            del want, diff, row_limit
            ms = _time_ms(kern, 10)
            dev_ms = _graph_ms(kern, 5)
            plain_ms = _time_ms(plain, 1, warm=0)
            if is_fp8:
                kg, vg = attention.gather_paged_cache_fp8(
                    {"k": ck, "v": cv, **kw}, bt, out_dtype=dtype)
            else:
                kg, vg = attention.gather_paged_cache(ck, cv, bt)
            rows_bound = (lens[:, None] if decode else lens[:, None] + 1
                          + torch.arange(C, device=DEVICE)[None, :])
            sq, sk, sv, mask = _sdpa_inputs(q, kg, vg, rows_bound)
            del kg, vg
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                sq, sk, sv, attn_mask=mask)
            lib_ms = _time_ms(sdpa, 5)
            lib_dev_ms = _graph_ms(sdpa, 5)
            del sq, sk, sv, mask
            args = ("decode" if decode else "chunk", dname, B, H, KH, hd, C,
                    MB, bs, lens.tolist(), q.element_size(),
                    1 if is_fp8 else ck.element_size(), 4 if is_fp8 else 0)
            bound_ms, bound_by = _bound(*args)
            body_ms, _ = _bound(*args, kv_reads=1.5)
            print(f"[kernels] {kernel} {name} q {dname} B={B} H={H} KH={KH} "
                  f"hd={hd} T={T}{'' if decode else ' C=%d' % C}: body "
                  f"{plan.body}, recompute plan splits={plan.splits} rows="
                  f"{plan.rows} groups={plan.groups} split_len="
                  f"{plan.split_len} smem={plan.smem}; max_abs_err="
                  f"{err:.3e} (limit {limit:.0e}"
                  f"{' and 2**-7 of its row max |o|' if dtype == torch.bfloat16 else ''}"
                  f"{'' if decode else ', plain row by row'}) ms={ms:.4f} "
                  f"device_ms={dev_ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms="
                  f"{lib_ms:.4f} sdpa_device_ms={lib_dev_ms:.4f} bound_ms="
                  f"{bound_ms:.5f} ({bound_by}; device/bound "
                  f"{dev_ms / bound_ms:.2f}) body_bytes_ms={body_ms:.5f} "
                  f"(K twice, V once; device/body bytes "
                  f"{dev_ms / body_ms:.2f}) {'ok' if ok else 'OVER LIMIT'}",
                  flush=True)
            if not ok:
                fail(f"{kernel} {name}: max abs error {err} over the limit")
            results[(kernel, name, dname)] = {
                "max_abs_err": err, "ms": ms, "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms, "library_device_ms": lib_dev_ms}
            del q, ck, cv, bt, kw, got
            torch.cuda.empty_cache()


# ----------------------------------------------------------------------
# 4. full-width forward, kernels against the plain gather path
# ----------------------------------------------------------------------

def _top2_margin(logits):
    top = logits.float().topk(2, dim=-1).values
    return top[..., 0] - top[..., 1]


def phase_forward(cfg, params, quant=None, fp8_kv=None) -> None:
    """One chunk_step and `steps` decode_steps of a full-width model
    (yi-6b; phase 12's families) through the kernels, every kernel call
    held against its plain version on the same inputs (the pool the call
    reads, its q); then the same steps through the plain path, for the
    end-to-end logits.  With `quant` (fp8 linears) the pool is e4m3 too,
    unless `fp8_kv` says otherwise."""
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import api, transformer
    fp8 = quant is not None if fp8_kv is None else fp8_kv
    tag = ("fp8_kv + fp8 linears" if quant is not None
           else "fp8_kv" if fp8 else "bf16")
    B, C, bs, steps = 4, 16, 16, 3
    MB = -(-264 // bs)
    g = torch.Generator(device=DEVICE).manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (B, C), generator=g,
                           device=DEVICE, dtype=torch.int32)
    n_tok = torch.tensor([16, 9, 16, 3], dtype=torch.int32, device=DEVICE)
    bt = torch.full((B, MB), -1, dtype=torch.int32, device=DEVICE)
    bt[:, :2] = torch.arange(2 * B, dtype=torch.int32,
                             device=DEVICE).reshape(B, 2)
    calls = {"decode": [0, 0.0], "chunk": [0, 0.0]}   # count, worst ratio
    orig = transformer._cache_attend

    def checked(q, k1, v1, cl, pos, positions, block_table, *, decode,
                kernel):
        o = orig(q, k1, v1, cl, pos, positions, block_table,
                 decode=decode, kernel=kernel)
        if kernel:
            kind = "decode" if decode else "chunk"
            plain = getattr(pk, f"paged_{kind}{'_fp8' if fp8 else ''}_plain")
            kw = ({"k_scale": cl["k_scale"], "v_scale": cl["v_scale"]}
                  if fp8 else {})
            want = plain(q, cl["k"], cl["v"], block_table,
                         pos + 1 if decode else pos, **kw).float()
            err = (o.float() - want).abs().max().item()
            rec = calls[kind]
            rec[0] += 1
            rec[1] = max(rec[1], err / max(want.abs().max().item(), 1e-30))
        return o

    def run(kernel: bool):
        cache = api.init_cache(cfg, B, 264, block_size=bs,
                               num_blocks=B * MB, device=DEVICE, fp8_kv=fp8)
        pos = torch.zeros(B, dtype=torch.int32, device=DEVICE)
        out = [api.chunk_step(cfg, params, cache, tokens, pos, n_tok, bt,
                              kernel=kernel, quant=quant)[0]]
        pos = n_tok.clone()
        for _ in range(steps):
            tok = out[-1].argmax(-1).to(torch.int32)
            out.append(api.decode_step(cfg, params, cache, tok, pos, bt,
                                       kernel=kernel, quant=quant)[0])
            pos = pos + 1
        return torch.stack(out)

    t0 = time.perf_counter()
    n0 = pk.launch_counts()
    transformer._cache_attend = checked
    try:
        lk = run(True)
    finally:
        transformer._cache_attend = orig
    lp = run(False)
    torch.cuda.synchronize()
    launched = {k: v - n0[k] for k, v in pk.launch_counts().items() if
                v > n0[k]}
    worst = max(r[1] for r in calls.values())
    e2e = (lk.float() - lp.float()).abs().max().item()
    agree = int((lk.argmax(-1) == lp.argmax(-1)).sum())
    print(f"[forward] {cfg.name} {tag} {cfg.num_layers} layers "
          f"d={cfg.d_model}, "
          f"B={B}: 1 chunk_step + {steps} decode_steps; kernel calls vs "
          f"plain on the same inputs: {calls['chunk'][0]} chunk + "
          f"{calls['decode'][0]} decode, max |diff| / max |o| = "
          f"{worst:.3e} (limit {ATTN_REL_LIMIT:.3e}); launched {launched}; "
          f"end to end, kernel path vs plain path (each feeding its own "
          f"argmax): max |logit diff| {e2e:.4f}, argmax agree "
          f"{agree}/{lk.shape[0] * B} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not (torch.isfinite(lk.float()).all()
            and torch.isfinite(lp.float()).all()):
        fail(f"full-width {tag} forward gave non-finite logits")
    if calls["chunk"][0] != cfg.num_layers or \
            calls["decode"][0] != steps * cfg.num_layers:
        fail(f"the {tag} forward did not go through the kernels once per "
             f"layer: {calls}")
    want_keys = ({"paged_chunk_fp8", "paged_decode_fp8"} if fp8
                 else {"paged_chunk", "paged_decode"})
    if set(launched) != want_keys:
        fail(f"the {tag} forward launched {launched}, not {want_keys}")
    if worst > ATTN_REL_LIMIT:
        fail(f"full-width {tag} kernel calls differ from the plain version "
             f"by {worst:.3e} of the output's magnitude (limit "
             f"{ATTN_REL_LIMIT:.3e})")


# ----------------------------------------------------------------------
# 5. serving
# ----------------------------------------------------------------------

def _eager_units(srv) -> None:
    """Run every work unit of `srv` through its private eager call (no
    graph) until `_graph_units`."""
    for unit in srv._units.values():
        unit.run = unit._eager


def _graph_units(srv) -> None:
    for unit in srv._units.values():
        unit.__dict__.pop("run", None)


def _pool_bytes(srv):
    """Bytes of the graph memory pool `srv`'s units share (the segments
    torch.cuda.memory_snapshot() files under its id), or None where the
    snapshot does not name pools."""
    import torch
    pool = next(iter(srv._units.values()))._pool
    segs = torch.cuda.memory_snapshot()
    if pool is None or not segs or "segment_pool_id" not in segs[0]:
        return None
    return sum(seg["total_size"] for seg in segs
               if tuple(seg["segment_pool_id"]) == tuple(pool))


def _unit_report(srv, label: str, eager: bool = False) -> dict:
    """Print `srv`'s compile_counts(), graphs captured, calls and graph
    pool bytes; fail unless every unit it called is one program and,
    on a graphed server, every unit called twice or more was captured
    exactly once (an eager server captures none)."""
    counts = srv.compile_counts()
    units = srv._units
    caps = {n: u.captures for n, u in units.items()}
    calls = {n: u.calls for n, u in units.items()}
    pool = None if eager else _pool_bytes(srv)
    print(f"[units] {label}: compile_counts {counts}, graphs captured "
          f"{caps}, calls {calls}, graph pool "
          f"{'not measured' if pool is None else '%d bytes' % pool}",
          flush=True)
    for n, u in units.items():
        want_caps = 0 if eager else int(u.calls >= 2)
        if counts[n] != int(u.calls > 0) or u.captures != want_caps:
            fail(f"{label}: unit {n} has {counts[n]} programs and "
                 f"{u.captures} graphs after {u.calls} calls")
    return {"counts": counts, "captures": caps, "pool_bytes": pool}


def phase_serve(cfg, params, fp8: bool = False, fp8_linear=None,
                label=None):
    """Both waves on one server, its work units replayed as CUDA graphs;
    with `fp8` the server stores an e4m3 pool and serves fp8 linears
    (bf16 linears with ``fp8_linear=False``: the moe family refuses
    them).  `label` names the run in the output (default bf16 / fp8).
    Every copy-on-write is checked, after its unit's call, to have
    copied every leaf (codes and scales).  Each unit is one program,
    captured once; a fresh server whose units run eagerly serves the
    same waves and must give the same streams bit for bit.  Returns
    (launch counts of the waves, the same by body and by work unit
    (measured around each dispatch), KV pool bytes, and the ShareGPT
    wave's requests, stats and eager recording)."""
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.runtime.server import (ChunkedServer, clone_requests,
                                            sharegpt_like_requests,
                                            sysprompt_sharegpt_requests)
    tag = label or ("fp8" if fp8 else "bf16")
    max_input, max_output = 128, 128
    max_len = max_input + max_output + 8       # as the CLI sizes it
    opts = dict(batch_slots=8, max_len=max_len, chunk=16, span=SERVE_SPAN,
                block_size=16, prefix_cache=True, fp8_kv=fp8,
                fp8_linear=fp8 if fp8_linear is None else fp8_linear,
                device=DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    srv = ChunkedServer(cfg, params, **opts)
    waves = [
        ("sharegpt", sharegpt_like_requests(
            16, cfg.vocab_size, max_input=max_input,
            max_output=max_output, seed=0)),
        # template_len 72 is not block aligned: a shared template ends
        # mid-block, so admission maps it copy-on-write
        ("sysprompt", sysprompt_sharegpt_requests(
            16, cfg.vocab_size, num_templates=2, template_len=72,
            max_input=max_input, max_output=max_output, seed=1)),
    ]
    cow_copies = []
    cow_unit = srv._units["cow_copy"]
    cow_run = cow_unit.run

    def checked_cow(src, dst):
        out = cow_run(src, dst)
        torch.cuda.synchronize()
        s_, d_ = int(src[0]), int(dst[0])
        same = all(torch.equal(*(x.view(torch.uint8)
                                 if x.element_size() == 1 else x
                                 for x in (leaf[:, d_], leaf[:, s_])))
                   for leaf in srv.cache.values())
        cow_copies.append((tuple(sorted(srv.cache)), same))
        return out

    cow_unit.run = checked_cow
    by_unit = _count_units(srv)
    ran0 = pk.device_launches(DEVICE)         # synchronizes
    pk.reset_launch_counts()                  # main path starts here
    all_stats = []
    try:
        for name, reqs in waves:
            stats = srv.serve(reqs)
            all_stats.append((name, reqs, stats, srv.metrics.counter_value(
                "serving.cow.resolves")))
    finally:
        del cow_unit.run
        _uncount_units(srv)
    launches = srv.launch_counts()            # main path ends here
    by_body = pk.launches_by_body()
    _check_ran(f"{tag} serve", pk.device_launches(DEVICE) - ran0, launches)
    del by_unit["emitted"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for name, reqs, st, cow in all_stats:
        print(f"[serve] {tag} {name}: {int(st['requests'])} requests, "
              f"{int(st['tokens'])} tokens in {st['seconds']:.2f} s = "
              f"{st['tokens_per_s']:.1f} tok/s; prefill "
              f"{st['prefill_seconds']:.2f} s / {int(st['chunk_steps'])} "
              f"chunk steps ({int(st['prefill_tokens'])} tokens), decode "
              f"{st['decode_seconds']:.2f} s / {int(st['decode_spans'])} "
              f"spans ({int(st['decode_tokens'])} tokens); pool peak "
              f"{int(st['peak_blocks_in_use'])}/{int(st['pool_blocks'])} "
              f"blocks, stalls {int(st['admission_stalls'])}; prefix hits "
              f"{int(st['prefix_hit_requests'])}/{int(st['requests'])}, "
              f"cached tokens {int(st['prefix_cached_tokens'])}/"
              f"{int(st['prompt_tokens_total'])}, evictions "
              f"{int(st['cache_evictions'])}, cow resolves {cow}",
              flush=True)
        for r in reqs:
            want = min(r.max_new, max_len - len(r.prompt))
            if not r.done or len(r.output) != want:
                fail(f"{tag} {name} request {r.rid}: done={r.done}, "
                     f"{len(r.output)} tokens, expected {want}")
            if not all(0 <= t < cfg.vocab_size for t in r.output):
                fail(f"{tag} {name} request {r.rid}: token out of vocab")
    kv_bytes = all_stats[0][2]["kv_bytes_per_device"]
    print(f"[serve] {tag} peak memory {peak_gb:.2f} GB; KV pool "
          f"{kv_bytes / 1e9:.4f} GB; launch counts {launches} (as many "
          f"run on the card), by body {by_body}; "
          f"copy-on-write copies checked {len(cow_copies)}, leaves "
          f"{cow_copies[0][0] if cow_copies else ()}", flush=True)
    _unit_report(srv, f"{tag} serve")
    del srv
    # the same waves on a fresh server whose units run eagerly, the
    # first recorded at every sample-head call (the contiguous phase
    # reads its partings there)
    t0 = time.perf_counter()
    eager = ChunkedServer(cfg, params, **opts)
    _eager_units(eager)
    recorded = None
    for name, reqs, _, _ in all_stats:
        again = clone_requests(reqs)
        if recorded is None:
            recorded = _serve_recording(eager, again)
            _eager_units(eager)
        else:
            eager.serve(again)
        same = [r.output for r in again] == [r.output for r in reqs]
        print(f"[serve] {tag} {name}: graph-replayed streams "
              f"{'equal' if same else 'DIFFER FROM'} the eager units' "
              f"bit for bit", flush=True)
        if not same:
            fail(f"{tag} {name}: graph-replayed and eager streams differ")
    _unit_report(eager, f"{tag} serve, eager units", eager=True)
    print(f"[serve] {tag} eager waves in {time.perf_counter() - t0:.1f} s",
          flush=True)
    del eager
    keys = (("paged_decode_fp8", "paged_chunk_fp8") if fp8
            else ("paged_decode", "paged_chunk"))
    if min(launches[k] for k in keys) <= 0:
        fail(f"a kernel of the {tag} path was never launched: {launches}")
    if any(sum(by_body[k].values()) != launches[k] for k in keys):
        fail(f"{tag} launches by body {by_body} do not add up to {launches}")
    # the decode kernel runs in the spans, the chunk kernel in the chunk
    # steps, each as measured around the dispatches
    L = cfg.num_layers
    st = [x[2] for x in all_stats]
    spans = sum(int(x["decode_spans"]) for x in st) * SERVE_SPAN
    chunks = sum(int(x["chunk_steps"]) for x in st)
    if (by_unit["span"][keys[0]] != launches[keys[0]]
            or by_unit["chunk"][keys[1]] != launches[keys[1]]
            or launches[keys[1]] != L * chunks
            or launches[keys[0]] != L * spans):
        fail(f"{tag} launches by work unit {by_unit} are not {launches}, "
             f"or not {L} x chunk steps ({chunks}) and {L} x span steps "
             f"({spans})")
    if all_stats[1][3] <= 0 or all_stats[1][2]["prefix_hit_requests"] <= 0:
        fail(f"the {tag} sysprompt wave hit no prefix / resolved no "
             "copy-on-write")
    if len(cow_copies) != sum(st[3] for st in all_stats) or \
            not all(same for _, same in cow_copies):
        fail(f"a {tag} copy-on-write did not copy every leaf: {cow_copies}")
    if fp8 and not all("k_scale" in leaves for leaves, _ in cow_copies):
        fail("an fp8 copy-on-write ran on a cache without scales")
    first = {"reqs": all_stats[0][1], "stats": all_stats[0][2],
             "rec": recorded, "peak_gb": peak_gb,
             "waves": [(n, st) for n, _, st, _ in all_stats]}
    return launches, by_body, by_unit, kv_bytes, first


# ----------------------------------------------------------------------
# 5b. the verify work unit: sample head, speculative decoding
# ----------------------------------------------------------------------

# the reference's own spec A/B (benchmarks/llm_gen.py): 8 repetitive
# requests (two motifs of 8 tokens tiled 3 times, 48 new tokens each)
SPEC_SERVER = dict(batch_slots=8, chunk=16, span=8, block_size=16,
                   max_len=96, prefix_cache=True)
# the least share of its drafts a warm wave accepts: its prompts repeat
# the cold wave's, so its drafts are the cold wave's own continuations
# (bf16: 0.818 on the H100, PERF.md); a spec step that scatters, rolls
# back or positions its window wrongly accepts few of them
ACCEPT_FLOOR = 0.5


def _spec_margin(lg) -> float:
    """Four bf16 steps at the top logit's magnitude (at least
    SMALL_MARGIN): two roundings apart can pick either token."""
    return max(SMALL_MARGIN, 2.0 ** -5 * float(lg.float().abs().max()))


UNITS = {"chunk": "_run_chunk_step", "span": "_run_decode_span",
         "verify": "_run_spec_step"}


def _count_units(srv, after=None) -> dict:
    """Wrap `srv`'s work-unit dispatches so that each reads the paged
    kernels' launch counts before and after it: returns {unit: Counter
    of launches by kernel}, and under "emitted" each dispatch's (unit,
    slot rids, the host's out_len before, after), filled as `srv`
    serves until `_uncount_units`.  `after(unit)` runs after each
    dispatch."""
    import collections
    from repro_torch.kernels import paged_attention as pk
    by_unit = {u: collections.Counter() for u in UNITS}
    by_unit["emitted"] = []

    def unit(name, run):
        def counted():
            rids = [r.rid if r is not None else None for r in srv.slot_req]
            before, out0 = pk.launch_counts(), srv.out_len.copy()
            out = run()
            after_counts = pk.launch_counts()
            by_unit[name].update({k: after_counts[k] - before[k]
                                  for k in after_counts})
            by_unit["emitted"].append((name, rids, out0,
                                       srv.out_len.copy()))
            if after is not None:
                after(name)
            return out
        return counted

    for name, attr in UNITS.items():
        setattr(srv, attr, unit(name, getattr(srv, attr)))
    return by_unit


def _check_ran(what: str, ran: int, launches: dict) -> None:
    """Fail unless the paged kernel ran `ran` times on the card (its
    own counter) where the wrappers counted `launches` (a replay adds
    the launches its capture counted)."""
    if ran != sum(launches.values()):
        fail(f"{what}: the paged kernel ran {ran} times on the card, the "
             f"wrappers counted {launches}")


def _uncount_units(srv) -> None:
    for attr in UNITS.values():
        delattr(srv, attr)


def _spec_wave(srv, reqs, per_req=None, record=False):
    """Serve a fresh copy of `reqs` on `srv`, the paged kernels' launch
    counts set to 0 just before and read just after, and read again
    around every dispatch of a work unit (chunk, span, verify step) for
    the launches by unit.  Every verify step copies its window,
    positions and returned tokens into buffers of `srv` (copies its
    graph captures, so a replay refills them), read after each verify
    dispatch, with each unit's emissions (the host's out_len before and
    after it); the served streams are rebuilt from them
    (`_check_chain`).  `record` serves through the units' eager calls,
    recording every sample-head call (`_serve_recording`).  Returns
    (outputs, stats, those counts (under "by_body" by body, under
    "by_unit" by work unit), the sample-head recording or None)."""
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import api
    from repro_torch.runtime.server import clone_requests
    rs = clone_requests(reqs)
    for i, r in enumerate(rs):
        if per_req is not None:
            r.sampling = per_req(i)
    steps = []
    orig_verify = api.verify_step

    def verify_spy(cfg, params, cache, tokens, pos, block_table, **kw):
        preds, cache = orig_verify(cfg, params, cache, tokens, pos,
                                   block_table, **kw)
        bufs = srv.__dict__.get("_verify_record")
        if bufs is None:      # at the unit's first (eager) call
            bufs = srv._verify_record = tuple(
                torch.empty_like(t) for t in (tokens, pos, preds))
        for b, t in zip(bufs, (tokens, pos, preds)):
            b.copy_(t)
        return preds, cache

    def after(name):
        if name == "verify":
            steps.append(tuple(b.cpu().clone() for b in srv._verify_record))

    by_unit = _count_units(srv, after)
    api.verify_step = verify_spy
    ran0 = pk.device_launches(DEVICE)         # synchronizes
    pk.reset_launch_counts()                  # this wave's path starts
    try:
        if record:
            rec = _serve_recording(srv, rs)
            stats = rec["stats"]
        else:
            rec, stats = None, srv.serve(rs)
        torch.cuda.synchronize()
        n = pk.launch_counts()                # and ends here
    finally:
        api.verify_step = orig_verify
        _uncount_units(srv)
    _check_ran("spec wave", pk.device_launches(DEVICE) - ran0, n)
    n["by_body"] = pk.launches_by_body()
    emitted = by_unit.pop("emitted")
    n["by_unit"] = {u: dict(c) for u, c in by_unit.items()}
    for r in rs:
        if not r.done or len(r.output) != r.max_new:
            fail(f"request {r.rid}: done={r.done}, {len(r.output)} tokens")
    _check_chain(rs, emitted, steps, srv.max_len)
    return [r.output for r in rs], stats, n, rec


def _check_chain(rs, emitted, steps, max_len) -> None:
    """Rebuild the served streams from what each work unit emitted.
    Every output index of every request is emitted by exactly one
    dispatch (the host's out_len before and after it), and each verify
    step's share is rebuilt from the step's own record: a decoding
    slot's window starts with its last emitted token at the position
    after its prompt and output (pos = prompt + emitted - 1), and the
    step emits its first min(accepted + 1, budget) returned tokens,
    `accepted` being the drafts that equal the returned token before
    them.  Exact: a fault in the spec step's scatter, acceptance, budget,
    cur_tok or positions shows whatever the model's numerics."""
    by_rid = {r.rid: r for r in rs}
    seen = {r.rid: [0] * len(r.output) for r in rs}
    verify = iter(steps)
    for name, rids, out0, out1 in emitted:
        rec = None
        if name == "verify":
            rec = tuple(t.tolist() for t in next(verify))
        for s, rid in enumerate(rids):
            if rid is None or out1[s] == out0[s]:
                continue
            r, k, n = by_rid[rid], int(out0[s]), int(out1[s] - out0[s])
            for i in range(k, k + n):
                seen[rid][i] += 1
            if rec is None:
                continue
            window, pos, preds = (x[s] for x in rec)
            K = len(window) - 1
            acc = next((j for j in range(K) if window[1 + j] != preds[j]),
                       K)
            want = min(acc + 1, r.max_new - k, max_len - 1 - pos)
            if (pos != len(r.prompt) + k - 1 or window[0] != r.output[k - 1]
                    or n != want or r.output[k:k + n] != preds[:n]):
                fail(f"request {rid}, verify step at output {k}: window "
                     f"{window} at pos {pos}, returned {preds}, emitted "
                     f"{r.output[k:k + n]} ({n}, expected {want})")
    if next(verify, None) is not None:
        fail("more verify records than verify dispatches")
    bad = {rid: c for rid, c in seen.items() if any(x != 1 for x in c)}
    if bad:
        fail(f"output indices not emitted exactly once: {bad}")


def _held_partings(reqs, base, other, rec, per_req, fp8=False) -> list:
    """Streams of `other` that part from `base`, each at the base run's
    recorded draw: (call, rid, token index, margin, limit)."""
    from repro_torch.models.sampling import GREEDY
    out = []
    for i, (r, a, b) in enumerate(zip(reqs, base, other)):
        j = _parting(a, b)
        if j is None:
            continue
        call, lg = rec[(r.rid, j)]
        sp = per_req(i) if per_req is not None else GREEDY
        out.append((call, r.rid, j, _draw_margin(lg, sp, len(r.prompt) + j),
                    _spec_margin(lg)))
    return out


def _verify_step_vs_decode(cfg, params, reqs, fp8: bool) -> None:
    """One full-width verify step, teacher-forced on the wave's prompts
    (the step that emits token 1): every chunk-kernel call held against
    its plain version on the same inputs (ATTN_REL_LIMIT of the
    output's magnitude); and beside it, on the same pool, the logits of
    the decode step that emits the same token through the decode kernel
    and through the plain gather path: how far two valid computations
    of one step lie apart at full width."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import api, transformer
    from repro_torch.te import linear as te_linear
    quant = te_linear.quantize_serving_params(params) if fp8 else None
    B, bs = len(reqs), SPEC_SERVER["block_size"]
    MB = SPEC_SERVER["max_len"] // bs
    cache = api.init_cache(cfg, B, MB * bs, block_size=bs, num_blocks=B * MB,
                           device=DEVICE, fp8_kv=fp8)
    bt = torch.arange(B * MB, dtype=torch.int32, device=DEVICE).reshape(B, MB)
    prompts = torch.tensor(np.stack([r.prompt for r in reqs]),
                           dtype=torch.int32, device=DEVICE)
    P = prompts.shape[1]
    pos = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    lg0, _ = api.chunk_step(cfg, params, cache, prompts, pos,
                            torch.full((B,), P, dtype=torch.int32,
                                       device=DEVICE), bt, kernel=True,
                            quant=quant)
    tok0 = lg0.argmax(-1).to(torch.int32)
    pos = torch.full((B,), P, dtype=torch.int32, device=DEVICE)
    clones = [{k: v.clone() for k, v in cache.items()} for _ in range(2)]
    dk, _ = api.decode_step(cfg, params, clones[0], tok0, pos, bt,
                            kernel=True, quant=quant)
    dp, _ = api.decode_step(cfg, params, clones[1], tok0, pos, bt,
                            kernel=False, quant=quant)
    window = tok0[:, None].expand(B, VERIFY_K + 1).contiguous()
    worst, calls = [0.0], [0]
    orig = transformer._cache_attend

    def checked(q, k1, v1, cl, pos_, positions, block_table, *, decode,
                kernel):
        o = orig(q, k1, v1, cl, pos_, positions, block_table,
                 decode=decode, kernel=kernel)
        plain = pk.paged_chunk_fp8_plain if fp8 else pk.paged_chunk_plain
        kw = ({"k_scale": cl["k_scale"], "v_scale": cl["v_scale"]}
              if fp8 else {})
        want = plain(q, cl["k"], cl["v"], block_table, pos_, **kw).float()
        err = (o.float() - want).abs().max().item()
        worst[0] = max(worst[0], err / max(want.abs().max().item(), 1e-30))
        calls[0] += 1
        return o

    transformer._cache_attend = checked
    try:
        x = transformer._chunk_fwd(cfg, params, cache, window, pos, bt,
                                   kernel=True, quant=quant)
    finally:
        transformer._cache_attend = orig
    vk = transformer.logits_fn(cfg, params, x[:, :1])[:, 0]
    torch.cuda.synchronize()
    top = dk.float().topk(2, dim=-1).values
    margin = (top[:, 0] - top[:, 1]).tolist()
    kp = (dk.float() - dp.float()).abs().amax(-1).tolist()
    vd = (vk.float() - dk.float()).abs().amax(-1).tolist()
    print(f"[spec] {'fp8' if fp8 else 'bf16'} teacher-forced step emitting "
          f"token 1 (B={B}, {P}-token prompts): verify step's "
          f"{calls[0]} chunk-kernel calls vs plain on the same inputs, max "
          f"|diff| / max |o| = {worst[0]:.3e} (limit {ATTN_REL_LIMIT:.3e}); "
          f"per slot: decode-kernel top-2 margin "
          f"{[round(m, 4) for m in margin]}, max |logit diff| decode kernel "
          f"vs decode plain {[round(v, 4) for v in kp]}, verify row 0 vs "
          f"decode kernel {[round(v, 4) for v in vd]}; argmax agree "
          f"kernel/plain {int((dk.argmax(-1) == dp.argmax(-1)).sum())}/{B}, "
          f"verify/decode {int((vk.argmax(-1) == dk.argmax(-1)).sum())}/{B}",
          flush=True)
    if calls[0] != cfg.num_layers or worst[0] > ATTN_REL_LIMIT:
        fail(f"the verify step's kernel calls: {calls[0]} calls, worst "
             f"{worst[0]:.3e} of the output's magnitude")
    if not all(torch.isfinite(t.float()).all() for t in (vk, dk)):
        fail("the teacher-forced verify step gave non-finite logits")


def phase_spec(cfg, params, fp8: bool = False) -> dict:
    """The verify work unit on full-width yi-6b: a greedy K=0 wave
    (recorded), a K=4 cold and a warm wave on one spec server, and the
    same two waves on a fresh spec server, which must repeat the tokens
    exactly.  K=4 is not held to K=0 token for token here: the
    random-weight deep stack turns a rounding difference between the
    verify step's and the decode step's sums into O(1) logit
    differences (phase 4), so each stream's first parting from K=0 is
    printed with the K=0 run's margin there, and the verify step is
    held kernel call by kernel call against plain instead
    (`_verify_step_vs_decode`, which also prints how far the decode
    kernel and the plain path lie apart at the same step); token
    streams are held at the reduced size (phase 7) and on the CPU (the
    tests).  Every spec wave's streams are rebuilt exactly from its
    verify steps' own records (`_check_chain`), and its launches are
    held: paged_decode 0 times, paged_chunk L x chunk steps in the
    chunk steps and L x verify steps in the verify steps.  A warm wave
    whose drafts do not enter the numerics (bf16; in the fp8 phase a
    server with the e4m3 pool and bf16 linears) must accept at least
    ACCEPT_FLOOR of its drafts; with fp8 linears the drafts enter the
    per-call activation scale, and acceptance is printed only.  bf16
    also: a sampled wave (temperature 0.5, top-k 4, seeds 300+i) at K=0
    against K=4 warm (partings printed), and a KS test of K=4 against
    K=0 at temperature 1.0 with disjoint seeds (p > 0.01).  Returns
    launches by kernel over the spec waves, by work unit and by body."""
    import numpy as np
    from repro_torch.models.sampling import SamplingParams, ks_two_sample
    from repro_torch.runtime.server import ChunkedServer, repetitive_requests
    tag = "fp8" if fp8 else "bf16"
    t0 = time.perf_counter()
    reqs = repetitive_requests(8, cfg.vocab_size, motif_len=8, reps=3,
                               max_output=48, seed=2)
    opts = dict(SPEC_SERVER, fp8_kv=fp8, fp8_linear=fp8, device=DEVICE)
    chunk_key = "paged_chunk_fp8" if fp8 else "paged_chunk"
    decode_key = "paged_decode_fp8" if fp8 else "paged_decode"
    k0_srv = ChunkedServer(cfg, params, **opts)
    base, st0, _, rec0 = _spec_wave(k0_srv, reqs, record=True)
    _unit_report(k0_srv, f"{tag} spec K=0, recorded (eager units)",
                 eager=True)
    # a prefix hit changes the prefill's rows (and with fp8 linears its
    # per-call activation scale): the same tokens need a fresh server
    del k0_srv
    k0_srv = ChunkedServer(cfg, params, **opts)
    # the unrecorded K=0 wave, through the graphs, is the one timed; the
    # recorded one ran the units eagerly: the same tokens bit for bit
    base2, st0, _, _ = _spec_wave(k0_srv, reqs)
    _unit_report(k0_srv, f"{tag} spec K=0")
    print(f"[spec] {tag} K=0: graph-replayed streams "
          f"{'equal' if base2 == base else 'DIFFER FROM'} the eager units' "
          "bit for bit", flush=True)
    if base2 != base:
        fail(f"{tag} K=0 waves through the graphs and through the eager "
             "units gave different tokens")
    del k0_srv
    launches = {chunk_key: 0, decode_key: 0}
    by_unit = {"chunk": 0, "verify": 0}
    by_body = {}

    def count(label, n, st):
        """Hold one spec wave's launches, each work unit's as measured
        around its dispatches, and add them up."""
        L, u = cfg.num_layers, n["by_unit"]
        want = {"chunk": L * int(st["chunk_steps"]),
                "verify": L * int(st["spec_steps"])}
        got = {k: u[k].get(chunk_key, 0) for k in want}
        print(f"[spec] {tag} {label}: {chunk_key} launches {n[chunk_key]} "
              f"(by work unit {got}), {decode_key} {n[decode_key]}",
              flush=True)
        if (n[decode_key] != 0 or got != want
                or n[chunk_key] != sum(want.values())):
            fail(f"{tag} {label}: {decode_key} launched {n[decode_key]} "
                 f"times (expected 0), {chunk_key} {n[chunk_key]} times, "
                 f"by work unit {got}, expected {L} x steps = {want}")
        launches[chunk_key] += n[chunk_key]
        for k in want:
            by_unit[k] += got[k]
        for b, c in n["by_body"][chunk_key].items():
            by_body[b] = by_body.get(b, 0) + c

    def spec_waves(label, floor=True, per_req=None, eager=False, **kw):
        """A cold and a warm wave on a fresh spec server (its units run
        eagerly with `eager`)."""
        srv = ChunkedServer(cfg, params, spec_decode=VERIFY_K,
                            **{**opts, **kw})
        if eager:
            _eager_units(srv)
        res = []
        for wave in ("cold", "warm"):
            out, st, n, _ = _spec_wave(srv, reqs, per_req=per_req)
            print(f"[spec] {tag} {label} K={VERIFY_K} {wave}: "
                  f"{int(st['tokens'])} tokens in {st['seconds']:.2f} s = "
                  f"{st['tokens_per_s']:.1f} tok/s; acceptance "
                  f"{st['spec_acceptance_rate']:.3f}, "
                  f"{st['spec_tokens_per_step']:.2f} tokens a slot a verify "
                  f"step; verify steps {int(st['spec_steps'])}, chunk steps "
                  f"{int(st['chunk_steps'])}, span steps "
                  f"{int(st['decode_spans'] - st['spec_steps'])}; streams "
                  f"rebuilt from the verify steps", flush=True)
            count(f"{label} {wave}", n, st)
            res.append((out, st))
        _unit_report(srv, f"{tag} spec {label}", eager=eager)
        if floor and not res[1][1]["spec_acceptance_rate"] >= ACCEPT_FLOOR:
            fail(f"{tag} {label}: the warm wave accepted "
                 f"{res[1][1]['spec_acceptance_rate']:.3f} of its drafts "
                 f"(floor {ACCEPT_FLOOR})")
        return res

    (cold, st_c), (warm, st_w) = spec_waves("server 1", floor=not fp8)
    print(f"[spec] {tag} K=0 wave: {st0['tokens_per_s']:.1f} tok/s "
          f"({int(st0['chunk_steps'])} chunk steps, "
          f"{int(st0['decode_spans'])} spans of {SPEC_SERVER['span']}); warm "
          f"K={VERIFY_K} / K=0 wall tokens/s "
          f"{st_w['tokens_per_s'] / st0['tokens_per_s']:.3f}", flush=True)
    # a fresh server running its units eagerly must repeat server 1's
    # graph-replayed waves exactly
    (cold2, _), (warm2, _) = spec_waves("server 2 (fresh, eager units)",
                                        floor=not fp8, eager=True)
    for label, out in (("cold", cold), ("warm", warm)):
        held = [(p[1], p[2], round(p[3], 4), round(p[4], 4))
                for p in _held_partings(reqs, base, out, rec0, None)]
        print(f"[spec] {tag} K={VERIFY_K} {label} vs K=0: {8 - len(held)}/8 "
              f"streams equal; first partings (rid, token, K=0 top-2 "
              f"margin, four bf16 steps), printed, not held: {held}",
              flush=True)
    print(f"[spec] {tag} a fresh spec server with eager units repeats the "
          f"graph-replayed cold wave {'exactly' if cold2 == cold else 'NOT'}"
          f" and warm {'exactly' if warm2 == warm else 'NOT'}", flush=True)
    if cold2 != cold or warm2 != warm:
        fail(f"{tag} spec waves differ between the graphed and the eager "
             "server")
    if fp8:
        # the e4m3 pool with bf16 linears: drafts stay out of the
        # numerics, so the warm wave accepts the cold wave's tokens
        spec_waves("server 3 (e4m3 pool, bf16 linears)", fp8_linear=False)
    _verify_step_vs_decode(cfg, params, reqs, fp8)
    if not fp8:
        # sampled: K=0 against K=4 warm, request by request
        sp = lambda i: SamplingParams(temperature=0.5, top_k=4,  # noqa
                                      seed=300 + i)
        s0_srv = ChunkedServer(cfg, params, **opts)
        s0, _, _, srec = _spec_wave(s0_srv, reqs, per_req=sp, record=True)
        del s0_srv
        _, (s4, st_s) = spec_waves("sampled (t=0.5, top-k 4)", floor=False,
                                   per_req=sp)
        held = _held_partings(reqs, s0, s4, srec, sp)
        print(f"[spec] bf16 sampled (t=0.5, top-k 4, seeds 300+i) K=0 vs "
              f"K={VERIFY_K} warm: {8 - len(held)}/8 streams equal; first "
              f"partings (rid, token, K=0 draw margin, four bf16 steps), "
              f"printed, not held: "
              f"{[(p[1], p[2], round(p[3], 4), round(p[4], 4)) for p in held]}"
              f"; acceptance {st_s['spec_acceptance_rate']:.3f}",
              flush=True)
        if s0 == base:
            fail("the sampled wave drew the greedy tokens")
        # KS: disjoint seeds at temperature 1.0
        ks0, _, _, _ = _spec_wave(
            ChunkedServer(cfg, params, **opts), reqs,
            per_req=lambda i: SamplingParams(temperature=1.0, seed=i))
        ks4, st_k, n, _ = _spec_wave(
            ChunkedServer(cfg, params, spec_decode=VERIFY_K, **opts), reqs,
            per_req=lambda i: SamplingParams(temperature=1.0, seed=1000 + i))
        count("KS (t=1.0)", n, st_k)
        d, pval = ks_two_sample(np.concatenate(ks0), np.concatenate(ks4))
        print(f"[spec] bf16 KS, K=0 vs K={VERIFY_K} at temperature 1.0, "
              f"disjoint seeds, {sum(map(len, ks0))} tokens a side: D="
              f"{d:.4f} p={pval:.4f} (must exceed 0.01)", flush=True)
        if not pval > 0.01:
            fail(f"K={VERIFY_K} and K=0 sampled distributions differ: "
                 f"p={pval}")
    print(f"[spec] {tag} phase in {time.perf_counter() - t0:.1f} s; "
          f"launches over the spec waves {launches}, by work unit "
          f"(measured around each dispatch) {by_unit}", flush=True)
    return {"launches": launches, "by_unit": by_unit, "by_body": by_body}


# ----------------------------------------------------------------------
# 5c-5e. the contiguous layout, the slot baseline, open-loop serving
# ----------------------------------------------------------------------

SERVE_MAX_LEN = 128 + 128 + 8      # phase 5's max_len, as the CLI sizes it


def _paged_unmoved(what: str, ran0: int, counts0: dict) -> None:
    """Fail unless no paged kernel ran since (ran0, counts0): the
    kernel's own counter on the card and the wrappers' counts."""
    from repro_torch.kernels import paged_attention as pk
    ran, counts = pk.device_launches(DEVICE) - ran0, pk.launch_counts()
    print(f"[{what}] paged kernels run on the card in this phase: {ran}; "
          f"wrappers' counts {'unchanged' if counts == counts0 else counts}",
          flush=True)
    if ran or counts != counts0:
        fail(f"{what}: the paged kernels ran ({ran} on the card, counts "
             f"{counts} from {counts0})")


def _tps(st) -> str:
    return (f"{int(st['tokens'])} tokens in {st['seconds']:.2f} s = "
            f"{st['tokens_per_s']:.1f} tok/s")


def _contiguous_steps_vs_kernel(cfg, params, reqs) -> None:
    """A chunk step (each of 8 prompts' first 16 tokens) and a decode
    step on a full-width contiguous cache, every attention call (the
    plain attention over the contiguous cache) held against the paged
    kernel on the same q and the same K/V, laid out as a pool of
    8-position blocks through an identity table: ATTN_REL_LIMIT of the
    output's magnitude, the bar phase 5b holds the verify step's kernel
    calls to.  (The same inputs: the served streams part because the
    two reads round differently, which the random-weight stack carries
    to O(1) logits.)"""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import api, transformer
    B, C, bs = 8, 16, 8
    T = SERVE_MAX_LEN + C
    cache = api.init_cache(cfg, B, T, paged=False, device=DEVICE)
    nb = T // bs
    bt = (torch.arange(B, device=DEVICE)[:, None] * nb
          + torch.arange(nb, device=DEVICE)[None, :]).to(torch.int32)
    toks = np.zeros((B, C), np.int32)
    n_tok = np.zeros(B, np.int32)
    for b, r in enumerate(reqs[:B]):
        n_tok[b] = min(len(r.prompt), C)
        toks[b, :n_tok[b]] = r.prompt[:n_tok[b]]
    worst, calls = [0.0], [0]
    orig = transformer._cache_attend

    def checked(q, k1, v1, cl, pos_, positions, block_table, *, decode,
                kernel):
        o = orig(q, k1, v1, cl, pos_, positions, block_table,
                 decode=decode, kernel=kernel)
        pool = [cl[k].reshape(B * nb, bs, *cl[k].shape[2:])
                for k in ("k", "v")]
        want = (pk.paged_decode(q, *pool, bt, pos_ + 1) if decode
                else pk.paged_chunk(q, *pool, bt, pos_)).float()
        err = (o.float() - want).abs().max().item()
        worst[0] = max(worst[0], err / max(want.abs().max().item(), 1e-30))
        calls[0] += 1
        return o

    t = lambda a: torch.from_numpy(a).to(DEVICE)      # noqa: E731
    transformer._cache_attend = checked
    try:
        lg, _ = api.chunk_step(cfg, params, cache, t(toks),
                               t(np.zeros(B, np.int32)), t(n_tok))
        lg2, _ = api.decode_step(cfg, params, cache,
                                 lg.argmax(-1).to(torch.int32), t(n_tok))
    finally:
        transformer._cache_attend = orig
    torch.cuda.synchronize()
    print(f"[contiguous] a chunk step and a decode step on a full-width "
          f"contiguous cache (T={T}): {calls[0]} plain attention calls vs "
          f"the paged kernel on the same inputs, max |diff| / max |o| = "
          f"{worst[0]:.3e} (limit {ATTN_REL_LIMIT:.3e})", flush=True)
    if calls[0] != 2 * cfg.num_layers or worst[0] > ATTN_REL_LIMIT:
        fail(f"contiguous attention vs the kernel: {calls[0]} calls, "
             f"worst {worst[0]:.3e} of the output's magnitude")
    if not all(torch.isfinite(x.float()).all() for x in (lg, lg2)):
        fail("the contiguous steps gave non-finite logits")


def phase_contiguous(cfg, params, paged: dict) -> None:
    """(a) ChunkedServer(paged=False) on full-width yi-6b (bf16): phase
    5's ShareGPT wave cold and warm on one server whose units replay
    CUDA graphs (compile_counts {chunk_step, decode_span}, no
    cow_copy; the warm wave repeats the cold one's tokens); tokens/s
    beside phase 5's paged server (cold) and a paged server without
    prefix cache (warm) on the same wave.  The contiguous streams part
    from the paged ones (plain attention against the kernel): each
    stream's first parting is printed with the paged run's top-2 margin
    there (phase 5's eager recording) and four bf16 steps
    (`_spec_margin`), not held, as phase 5b prints K=4 against K=0; the
    contiguous attention calls are held to the kernel on the same
    inputs instead (`_contiguous_steps_vs_kernel`).  Then spec K=4 on
    phase 5b's repetitive traffic (4 < chunk), cold and warm, on a
    graphed server and on one whose units run eagerly: the same streams
    bit for bit.  No paged kernel runs in the contiguous waves (their
    counter on the card and the wrappers')."""
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.runtime.server import (ChunkedServer, clone_requests,
                                            repetitive_requests)
    t0 = time.perf_counter()
    opts = dict(batch_slots=8, max_len=SERVE_MAX_LEN, chunk=16,
                span=SERVE_SPAN, paged=False, device=DEVICE)
    reqs = paged["reqs"]
    psrv = ChunkedServer(cfg, params, **dict(opts, paged=True,
                                             block_size=16,
                                             prefix_cache=False))
    psrv.serve(clone_requests(reqs))
    st_pw = psrv.serve(clone_requests(reqs))
    del psrv
    ran0, counts0 = pk.device_launches(DEVICE), pk.launch_counts()
    srv = ChunkedServer(cfg, params, **opts)
    cold, warm = clone_requests(reqs), clone_requests(reqs)
    st_cold, st_warm = srv.serve(cold), srv.serve(warm)
    out = [r.output for r in cold]
    for r in cold:
        want = min(r.max_new, SERVE_MAX_LEN - len(r.prompt))
        if not r.done or len(r.output) != want:
            fail(f"contiguous request {r.rid}: {len(r.output)} tokens, "
                 f"expected {want}")
    if [r.output for r in warm] != out:
        fail("the contiguous server's warm wave gave other tokens")
    rep = _unit_report(srv, "bf16 contiguous")
    if rep["counts"] != {"chunk_step": 1, "decode_span": 1}:
        fail(f"contiguous compile_counts {rep['counts']}")
    del srv
    print(f"[contiguous] ShareGPT wave, bf16: contiguous cold "
          f"{_tps(st_cold)}, warm {_tps(st_warm)} (prefill "
          f"{st_warm['prefill_seconds']:.2f} s, decode "
          f"{st_warm['decode_seconds']:.2f} s); paged (phase 5, cold) "
          f"{paged['stats']['tokens_per_s']:.1f} tok/s, paged without "
          f"prefix cache, warm {_tps(st_pw)}; contiguous / paged warm "
          f"{st_warm['tokens_per_s'] / st_pw['tokens_per_s']:.3f}",
          flush=True)
    partings = []
    for r, c in zip(reqs, out):
        j = _parting(r.output, c)
        if j is None:
            continue
        _, lg = paged["rec"][(r.rid, j)]
        top = lg.float().topk(2).values
        partings.append((r.rid, j, round(float(top[0] - top[1]), 4),
                         round(_spec_margin(lg), 4)))
    print(f"[contiguous] {len(reqs) - len(partings)}/{len(reqs)} streams "
          f"equal the paged server's; first partings (rid, token, paged "
          f"top-2 margin, four bf16 steps), printed, not held: {partings}",
          flush=True)
    # spec decode on the contiguous layout: phase 5b's traffic
    spec_reqs = repetitive_requests(8, cfg.vocab_size, motif_len=8, reps=3,
                                    max_output=48, seed=2)
    sopts = dict(opts, max_len=SPEC_SERVER["max_len"],
                 spec_decode=VERIFY_K)
    spec_out = []
    for eager_units in (False, True):
        sp = ChunkedServer(cfg, params, **sopts)
        if eager_units:
            _eager_units(sp)
        waves = []
        for wave in ("cold", "warm"):
            rs = clone_requests(spec_reqs)
            st = sp.serve(rs)
            if not all(r.done and len(r.output) == r.max_new for r in rs):
                fail(f"contiguous spec {wave} wave: a request is short")
            waves.append([r.output for r in rs])
            print(f"[contiguous] spec K={VERIFY_K} {wave} "
                  f"({'eager units' if eager_units else 'graphs'}): "
                  f"{_tps(st)}; acceptance "
                  f"{st['spec_acceptance_rate']:.3f}, "
                  f"{st['spec_tokens_per_step']:.2f} tokens a slot a "
                  f"verify step over {int(st['spec_steps'])} verify steps",
                  flush=True)
        rep = _unit_report(sp, f"bf16 contiguous spec K={VERIFY_K}"
                           + (", eager units" if eager_units else ""),
                           eager=eager_units)
        if rep["counts"] != {"chunk_step": 1, "decode_span": 0,
                             "verify_step": 1}:
            fail(f"contiguous spec compile_counts {rep['counts']}")
        spec_out.append(waves)
        del sp
    print(f"[contiguous] spec graph-replayed streams "
          f"{'equal' if spec_out[0] == spec_out[1] else 'DIFFER FROM'} "
          f"the eager units' bit for bit (cold and warm)", flush=True)
    if spec_out[0] != spec_out[1]:
        fail("contiguous spec streams differ between graphs and eager")
    _paged_unmoved("contiguous", ran0, counts0)
    _contiguous_steps_vs_kernel(cfg, params, reqs)
    print(f"[contiguous] phase in {time.perf_counter() - t0:.1f} s",
          flush=True)


def phase_slot(cfg, params) -> None:
    """(b) The slot baseline at full width, as the reference measures it
    (benchmarks/llm_gen.py): SlotServer, ChunkedServer(paged=False) and
    a paged ChunkedServer (12 blocks, no prefix cache), 4 slots,
    max_len 96, chunk 16, span 8, on 8 ShareGPT-like requests (seed 0,
    max_input 32, max_output 16: the CLI's defaults), each a fresh
    server's first wave (the reference's rows include its compiles;
    here the units' first, eager calls and captures); the chunked
    servers also a warm wave.  Tokens/s side by side: chunked / slot is
    the reference's measured speedup.  The slot server's
    compile_counts() is one decode program and one prefill program a
    distinct prompt length, every unit called twice or more captured
    once, and no paged kernel runs in its wave."""
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.runtime.server import (ChunkedServer, SlotServer,
                                            clone_requests,
                                            sharegpt_like_requests)
    t0 = time.perf_counter()
    reqs = sharegpt_like_requests(8, cfg.vocab_size, max_input=32,
                                  max_output=16, seed=0)
    ran0, counts0 = pk.device_launches(DEVICE), pk.launch_counts()
    slot = SlotServer(cfg, params, batch_slots=4, max_len=96, device=DEVICE)
    rs = clone_requests(reqs)
    st_slot = slot.serve(rs)
    base = [r.output for r in rs]
    if not all(r.done and len(r.output) == r.max_new for r in rs):
        fail("slot wave: a request is short")
    _paged_unmoved("slot", ran0, counts0)
    counts = slot.compile_counts()
    units = [slot._decode, *slot._prefill.values()]
    print(f"[slot] compile_counts {counts} "
          f"({len({len(r.prompt) for r in reqs})} distinct prompt "
          f"lengths); units called twice or more "
          f"{sum(u.calls >= 2 for u in units)}, graphs captured "
          f"{sum(u.captures for u in units)}", flush=True)
    if (counts != {"decode_step": 1,
                   "prefill_one": len({len(r.prompt) for r in reqs})}
            or any(u.captures != int(u.calls >= 2) for u in units)):
        fail(f"slot server: compile_counts {counts}, or a unit not "
             f"captured once")
    del slot
    runs = {}
    for name, kw in (("contiguous", dict(paged=False)),
                     ("paged", dict(block_size=16, num_blocks=12,
                                    prefix_cache=False))):
        srv = ChunkedServer(cfg, params, batch_slots=4, max_len=96,
                            chunk=16, span=8, device=DEVICE, **kw)
        for wave in ("cold", "warm"):
            rs = clone_requests(reqs)
            runs[(name, wave)] = (srv.serve(rs), [r.output for r in rs])
        del srv
    st = {k: v[0] for k, v in runs.items()}
    print(f"[slot] first waves: slot {_tps(st_slot)} (prefill "
          f"{st_slot['prefill_seconds']:.2f} s, decode "
          f"{st_slot['decode_seconds']:.2f} s); chunked contiguous "
          f"{_tps(st[('contiguous', 'cold')])}; chunked paged "
          f"{_tps(st[('paged', 'cold')])}; chunked contiguous / slot "
          f"{st[('contiguous', 'cold')]['tokens_per_s'] / st_slot['tokens_per_s']:.2f}x"
          f"; warm chunked contiguous {_tps(st[('contiguous', 'warm')])}, "
          f"paged {_tps(st[('paged', 'warm')])}", flush=True)
    for name in ("contiguous", "paged"):
        other = runs[(name, "cold")][1]
        parted = [(r.rid, _parting(a, b)) for r, a, b in
                  zip(reqs, base, other) if a != b]
        print(f"[slot] chunked {name} vs slot: {8 - len(parted)}/8 streams "
              f"equal, first partings (rid, token), printed: {parted}",
              flush=True)
    print(f"[slot] phase in {time.perf_counter() - t0:.1f} s", flush=True)


def _sync_warnings(fn):
    """(fn's result, a Counter of the places (file:line) of the
    synchronizations torch.cuda's sync debug mode "warn" reports while
    it runs)."""
    import collections
    import warnings
    import torch
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, collections.Counter(
        f"{os.path.relpath(w.filename, ROOT)}:{w.lineno}" for w in seen
        if "synchroniz" in str(w.message).lower())


def _error_on_sync_in_units(srv) -> list:
    """Run every unit call of `srv` under sync debug mode "error" (the
    previous mode restored after it); returns the list the calls append
    to."""
    import torch
    calls = []
    for unit in srv._units.values():
        def checked(*ops, _run=unit.run):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                return _run(*ops)
            finally:
                torch.cuda.set_sync_debug_mode(mode)
                calls.append(1)
        unit.run = checked
    return calls


class _HeadRecorder:
    """Every sample-head call of one server's work units, kept per
    dispatch, through its CUDA graphs.  Installed as
    `sampling.sample_tokens`, the spy copies each call's logits and
    emission positions into static buffers while a unit's body runs in
    Python (its eager call and its capture), so every replay refills
    them; after each dispatch, while `keep` is set, they are cloned on
    the device (no host read) with the dispatch's slots.  The spy must
    be in place before the server's units are first called."""

    def __init__(self, srv):
        from repro_torch.models import sampling
        self.srv, self.sampling = srv, sampling
        self.orig = sampling.sample_tokens
        self.unit, self.k = None, 0
        self.bufs = {}            # (unit, k-th head call) -> buffers
        self.keep = False
        self.kept = []
        sampling.sample_tokens = self._spy
        for name, attr in UNITS.items():
            setattr(srv, attr, self._wrap(name, getattr(srv, attr)))

    def close(self) -> None:
        self.sampling.sample_tokens = self.orig

    def _spy(self, logits, temp, top_k, top_p, seed, index):
        if self.unit is not None:
            key = (self.unit, self.k)
            self.k += 1
            if key not in self.bufs:      # at the unit's eager call
                self.bufs[key] = (logits.detach().clone(), index.clone())
            for buf, t in zip(self.bufs[key], (logits, index)):
                buf.copy_(t)
        return self.orig(logits, temp, top_k, top_p, seed, index)

    def _wrap(self, name, run):
        def recorded():
            slots = [(r.rid, len(r.prompt)) if r is not None else None
                     for r in self.srv.slot_req]
            self.unit, self.k = name, 0
            try:
                out = run()
            finally:
                self.unit = None
            if self.keep:
                calls = sorted(k for u, k in self.bufs if u == name)
                self.kept.append((name, slots, [
                    tuple(b.clone() for b in self.bufs[(name, k)])
                    for k in calls]))
            return out
        return recorded

    def table(self) -> dict:
        """{(rid, output index): (unit, logits row)} of the kept
        dispatches, then forgets them.  A later call's record of a
        position is the one that emitted it; mid-prompt slots get
        negative indices and finished slots indices past their output,
        which nothing reads."""
        import torch
        calls = [(name, slots, lg, ix) for name, slots, heads in self.kept
                 for lg, ix in heads]
        self.kept = []
        if not calls:
            return {}
        index = torch.stack([ix for _, _, _, ix in calls]).cpu()
        out = {}
        for (name, slots, lg, _), ix in zip(calls, index):
            for s_, slot in enumerate(slots):
                if slot is not None:
                    rid, plen = slot
                    out[(rid, int(ix[s_]) - plen)] = (name, lg[s_])
        return out


def _emitted_rows(label, reqs, outs, tab) -> None:
    """Fail unless every output token of the recorded wave has a
    recorded row whose argmax is that token."""
    import torch
    rows = [tab[(r.rid, i)][1] for r, o in zip(reqs, outs)
            for i in range(len(o))]
    if torch.stack(rows).argmax(-1).cpu().tolist() != [
            t for o in outs for t in o]:
        fail(f"bf16 online {label}: a recorded row's argmax is not the "
             "token it emitted")


def _held_rows(label, reqs, base, base_tab, outs, tab) -> str:
    """Hold one recorded wave's streams `outs` against the recorded base
    wave's (both greedy bf16, one server).  Row i of a stream depends on
    its tokens before i and on the work unit that processed each of
    them (the one that emitted the next token): where both match the
    base's up to and including row i, its logits must equal the base's
    bit for bit, since only the batch around it differs; a stream may
    therefore part only after a row that another unit emitted (the
    recording is the emission's: `_emitted_rows`).  Returns the summary
    printed."""
    import torch
    compared, moved, partings = 0, [], []
    for r, a, b in zip(reqs, base, outs):
        j = _parting(a, b)
        n = len(a) if j is None else min(j + 1, len(a), len(b))
        d = next((i for i in range(n)
                  if base_tab[(r.rid, i)][0] != tab[(r.rid, i)][0]), n)
        for i in range(d):
            compared += 1
            if not torch.equal(base_tab[(r.rid, i)][1], tab[(r.rid, i)][1]):
                moved.append((r.rid, i))
        if j is not None and j < n:
            lb, lo = base_tab[(r.rid, j)][1], tab[(r.rid, j)][1]
            partings.append((r.rid, j, d,
                             round(float(_top2_margin(lb)), 4),
                             round(float((lb.float() - lo.float()).abs()
                                         .max()), 4)))
    if moved or not compared:
        fail(f"bf16 online {label}: rows whose tokens and work units up to "
             f"them equal the base's differ from its logits: {moved} "
             f"({compared} compared)")
    return (f"{compared} rows with the base's tokens and units compared, "
            f"bit for bit equal; partings (rid, token, first row another "
            f"unit emitted, base top-2 margin, max |logit diff| there): "
            f"{partings}")


def phase_online(cfg, params, fp8: bool = False) -> dict:
    """(c) Open-loop serving on the paged server with the kernels
    (phase 5's server and ShareGPT wave), bf16 or, with `fp8`, e4m3 KV
    and fp8 linears: serve_online(closed_stream) on one server and
    serve() on another give the same streams bit for bit, admission
    order and compile counts; around one warm wave of each, sync debug
    mode "warn" finds no synchronization in the online loop that
    serve() does not have (by place, file:line, and count), and
    "error" around every unit call of the online wave raises none.
    Then the reference's rate sweep (benchmarks/llm_gen.py): calibrate
    at 0.5x the closed-loop request rate (Poisson, seed 4), SLO = 2x
    its p99 TTFT and p99 TPOT, then Poisson streams (seed 5) at 0.5x,
    1x and 3x, each with offered rps, tokens/s, TTFT, TPOT and
    queue-delay p50/p99, attainment, goodput, peak queue depth and the
    windowed summary; the knee (max_sustainable_rate at 0.9).  Streams
    against the calibration run's: in bf16 every sample-head row of the
    calibration and of each rate is recorded through the online
    server's graphs (`_HeadRecorder`) and held by `_held_rows` (which
    unit emits a token depends on the arrivals, and a decode row of a
    chunk step and a span's decode step round differently: products of
    M = 128 and M = 8 rows, the chunk and decode kernels); in fp8
    (per-call activation scales: a row depends on its neighbours) the
    partings are printed.  The paged kernel's counter on the card
    equals the wrappers' counts over the phase.  Returns its launches,
    by body and by work unit."""
    from repro_torch.obs import Tracer
    from repro_torch.runtime.server import (ChunkedServer,
                                            sharegpt_like_requests)
    tag = "fp8" if fp8 else "bf16"
    t0 = time.perf_counter()
    opts = dict(batch_slots=8, max_len=SERVE_MAX_LEN, chunk=16,
                span=SERVE_SPAN, block_size=16, prefix_cache=True,
                fp8_kv=fp8, fp8_linear=fp8, device=DEVICE)
    reqs = sharegpt_like_requests(16, cfg.vocab_size, max_input=128,
                                  max_output=128, seed=0)
    ta, tb = Tracer(), Tracer()
    a = ChunkedServer(cfg, params, tracer=ta, **opts)
    b = ChunkedServer(cfg, params, tracer=tb, **opts)
    units_a, units_b = _count_units(a), _count_units(b)
    heads = None if fp8 else _HeadRecorder(b)     # before b's captures
    try:
        out = _online_waves(a, b, ta, tb, reqs, tag, heads)
    finally:
        if heads is not None:
            heads.close()
    _uncount_units(a)
    _uncount_units(b)
    out["by_unit"] = {u: dict(units_a[u] + units_b[u])
                      for u in ("chunk", "span")}
    print(f"[online] {tag} phase in {time.perf_counter() - t0:.1f} s; "
          f"paged launches {out['launches']} (as many run on the card), "
          f"by work unit {out['by_unit']}", flush=True)
    return out


def _online_waves(a, b, ta, tb, reqs, tag, heads) -> dict:
    """phase_online's waves on servers `a` and `b` (tracers `ta`, `tb`;
    `heads` records b's sample heads in bf16, None in fp8)."""
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.obs import (SLOSpec, max_sustainable_rate,
                                 request_latency_summary, slo_report,
                                 window_series, window_summary)
    from repro_torch.runtime.arrivals import closed_stream, poisson_stream
    from repro_torch.runtime.server import clone_requests
    ran0 = pk.device_launches(DEVICE)         # synchronizes
    pk.reset_launch_counts()                  # the phase's path starts
    ra, rb = clone_requests(reqs), clone_requests(reqs)
    a.serve(ra)
    b.serve_online(closed_stream(rb))

    def admits(tr):
        return [(x["rid"], x["slot"]) for _, k, x in tr.events
                if k == "admit"]

    same = ([r.output for r in ra] == [r.output for r in rb]
            and admits(ta) == admits(tb)
            and a.compile_counts() == b.compile_counts())
    print(f"[online] {tag} serve_online(closed_stream) vs serve(): streams, "
          f"admission order and compile_counts {a.compile_counts()} "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        fail(f"{tag} serve_online on a closed stream differs from serve()")
    st_closed, at_serve = _sync_warnings(
        lambda: a.serve(clone_requests(reqs)))
    calls = _error_on_sync_in_units(b)
    st_open, at_online = _sync_warnings(
        lambda: b.serve_online(closed_stream(clone_requests(reqs))))
    for unit in b._units.values():
        del unit.run
    extra = at_online - at_serve
    print(f"[online] {tag} warm closed wave: serve() {_tps(st_closed)}, "
          f"synchronizations {dict(at_serve)}; serve_online(closed_stream)"
          f" {_tps(st_open)}, {dict(at_online)}, none inside its "
          f"{len(calls)} unit calls; none that serve() does not have: "
          f"{'yes' if not extra else dict(extra)}", flush=True)
    if extra or not calls:
        fail(f"{tag} the online wave synchronizes where serve() does not: "
             f"{dict(extra)}")
    closed_rps = st_open["requests"] / st_open["seconds"]

    def recorded(run, stream):
        """Serve `stream` open-loop on b, its sample heads kept (bf16)."""
        tb.clear()
        if heads is not None:
            heads.keep = True
        try:
            st = b.serve_online(stream)
        finally:
            if heads is not None:
                heads.keep = False
        tab = heads.table() if heads is not None else None
        if tab is not None:
            _emitted_rows(tag, run, [r.output for r in run], tab)
        return st, tab

    cal = clone_requests(reqs)
    cal_st, cal_tab = recorded(
        cal, poisson_stream(cal, 0.5 * closed_rps, seed=4))
    cal_lat = request_latency_summary(tb)
    slo = SLOSpec(ttft_s=max(2.0 * cal_lat["ttft_s"]["p99"], 1e-3),
                  tpot_s=max(2.0 * cal_lat["tpot_s"]["p99"], 1e-3))
    window_s = max(cal_st["seconds"] / 8.0, 0.02)
    cal_out = [r.output for r in cal]
    print(f"[online] {tag} closed-loop rate {closed_rps:.3f} req/s; "
          f"calibration at 0.5x (seed 4): {_tps(cal_st)}, p99 TTFT "
          f"{cal_lat['ttft_s']['p99'] * 1e3:.1f} ms, p99 TPOT "
          f"{cal_lat['tpot_s']['p99'] * 1e3:.2f} ms -> SLO TTFT "
          f"{slo.ttft_s * 1e3:.1f} ms, TPOT {slo.tpot_s * 1e3:.2f} ms; "
          f"windows of {window_s * 1e3:.0f} ms", flush=True)

    def run_at(rate):
        run = clone_requests(reqs)
        st, tab = recorded(run, poisson_stream(run, rate, seed=5))
        rep = slo_report(tb, slo, st["seconds"])
        lat = request_latency_summary(tb)
        wsum = window_summary(window_series(tb, window_s))
        outs = [r.output for r in run]
        label = f"{rate / closed_rps:.1f}x"
        if tab is None:
            parted = [(r.rid, _parting(c, o))
                      for r, c, o in zip(run, cal_out, outs) if c != o]
            rows = f"first partings (rid, token), printed: {parted}"
        else:
            rows = _held_rows(label, run, cal_out, cal_tab, outs, tab)
        ms = {k: (lat[k]["p50"] * 1e3, lat[k]["p99"] * 1e3)
              for k in ("ttft_s", "tpot_s", "queue_delay_s")}
        tps = wsum["tokens_per_s"]
        print(f"[online] {tag} {label}: offered "
              f"{st['offered_rate_rps']:.3f} req/s, {_tps(st)}; TTFT p50/p99 "
              f"{ms['ttft_s'][0]:.1f}/{ms['ttft_s'][1]:.1f} ms, TPOT "
              f"{ms['tpot_s'][0]:.2f}/{ms['tpot_s'][1]:.2f} ms, queue "
              f"delay {ms['queue_delay_s'][0]:.1f}/"
              f"{ms['queue_delay_s'][1]:.1f} ms; attainment "
              f"{rep['attainment_strict']:.3f} ({rep['met']}/"
              f"{rep['finished'] + rep['unfinished']}), goodput "
              f"{rep['goodput_tok_s']:.1f} of {rep['throughput_tok_s']:.1f}"
              f" tok/s; peak queue depth {int(st['peak_queue_depth'])}, "
              f"idle {st['idle_s']:.2f} s; windowed ({wsum['n_windows']} x "
              f"{window_s * 1e3:.0f} ms) tok/s p50/p95/p99 "
              f"{tps['p50']:.1f}/{tps['p95']:.1f}/{tps['p99']:.1f}, busy "
              f"p50 {wsum['busy_frac']['p50']:.2f}; streams: "
              f"{sum(c == o for c, o in zip(cal_out, outs))}/{len(run)} "
              f"equal the calibration's; {rows}", flush=True)
        return rep

    knee = max_sustainable_rate(
        run_at, [closed_rps * m for m in (0.5, 1.0, 3.0)],
        target_attainment=0.9)
    print(f"[online] {tag} max sustainable rate at attainment >= 0.9: "
          f"{knee['max_sustainable_rps']:.3f} req/s "
          f"({knee['max_sustainable_rps'] / closed_rps:.1f}x)", flush=True)
    launches = pk.launch_counts()             # the phase's path ends
    by_body = pk.launches_by_body()
    _check_ran(f"{tag} online", pk.device_launches(DEVICE) - ran0, launches)
    return {"launches": launches, "by_body": by_body}


# ----------------------------------------------------------------------
# 6. where the time goes
# ----------------------------------------------------------------------

def _device_profile():
    """torch.profiler over the device's activity alone: the readings
    below need only its kernels, and host-side op records cost far more
    to record and to parse than the device time they sit beside
    (scripts/profiler_cost.py measures both on a training step)."""
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def _device_events(prof) -> list:
    """(name, ms) of each device event (kernel, copy, set) of a
    torch.profiler run, read from its raw trace: the same events and
    durations as prof.events() gives, without building its event tree
    (scripts/profiler_cost.py holds the two equal and times both)."""
    from torch.autograd import DeviceType
    return [(e.name(), e.duration_ns() / 1e6)
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == DeviceType.CUDA]


def _device_ms_by_kernel(prof, steps: int):
    """Device ms a step of each kernel name in a torch.profiler run of
    `steps` steps."""
    import collections
    by_name = collections.Counter()
    for name, ms in _device_events(prof):
        by_name[name] += ms / steps
    return by_name


def _kernel_launches(prof, name: str) -> int:
    """Device launches of kernels whose name holds `name` in a
    torch.profiler run."""
    return sum(1 for n, _ in _device_events(prof) if name in n)


def phase_profile(cfg, params, fp8: bool = False, label=None) -> dict:
    """Wall and device time of full-width yi-6b's work units as the
    server replays them (B=8, 128 cached tokens per slot, chunk 16,
    span 8, the sample head at temperature 0.5 / top-k 4 in every
    unit): a span of 8 decode steps, a chunk step and a verify step
    (K=4: C=5 rows).  Each unit runs its eager call, its capture and a
    replay first; then wall ms a dispatch (host clock around a replay
    and the server's `_sync`), device ms a replay (CUDA events around
    back-to-back replays), the graph pool's bytes, and the kernels that
    take the device time, from torch.profiler over replays (no kernel
    seen fails).  The paged kernel's own counter on the card
    (`pk.device_launches`) over those replays must equal the launches
    the unit counted at capture and adds per replay
    (`unit.replay_launches`); the profiler's count of
    `paged_attention_kernel` events is printed beside it, not held: it
    drops records under load (1245 of 1280 in one run).  Then the sample head
    alone over [8, 64000] (a chunk or span step's) and [8, 5, 64000] (a
    verify step's) logits, eager and as a graph replay.  With `fp8` the
    pool is e4m3 and the linears fp8.  `label` prefixes the output (default "fp8 " / "").  Returns each
    unit's wall ms, device ms and top kernels."""
    import numpy as np
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models import sampling
    from repro_torch.runtime.server import ChunkedServer
    B, bs, C, steps, max_len = 8, 16, 16, 5, 264
    tag = label or ("fp8 " if fp8 else "")
    srv = ChunkedServer(cfg, params, batch_slots=B, max_len=max_len,
                        chunk=C, span=SERVE_SPAN, block_size=bs,
                        spec_decode=VERIFY_K, fp8_kv=fp8, fp8_linear=fp8,
                        device=DEVICE)
    MB = srv.max_blocks
    srv.block_table[:] = np.arange(B * MB, dtype=np.int32).reshape(B, MB)
    srv.samp_temp[:], srv.samp_top_k[:] = 0.5, 4
    srv.samp_seed[:] = np.arange(B)
    i32 = lambda v: np.full(B, v, np.int32)               # noqa: E731
    samp = srv._samp_mirrors()
    ops = {
        "chunk_step": (np.zeros((B, C), np.int32), i32(128), i32(C),
                       np.zeros(B, bool), np.ones(B, bool), i32(0), *samp,
                       srv.block_table),
        "decode_span": (i32(128), i32(0), np.ones(B, bool), i32(10 ** 6),
                        *samp, srv.block_table),
        "verify_step": (i32(128), i32(0), np.ones(B, bool), i32(10 ** 6),
                        *samp, srv.block_table),
    }
    res = {}
    for name, args in ops.items():
        unit = srv._units[name]
        for _ in range(3):                   # eager, capture, replay
            unit.run(*args)
        srv._sync()
        if unit.captures != 1:
            fail(f"profile: {name} was not captured")
        t0 = time.perf_counter()
        for _ in range(steps):
            unit.run(*args)
            srv._sync()
        wall = (time.perf_counter() - t0) / steps * 1e3
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(steps):
            unit.run(*args)
        end.record()
        torch.cuda.synchronize()
        dev = start.elapsed_time(end) / steps
        ran0 = pk.device_launches(DEVICE)
        with _device_profile() as prof:
            for _ in range(steps):
                unit.run(*args)
            torch.cuda.synchronize()
        ran = pk.device_launches(DEVICE) - ran0
        by_name = _device_ms_by_kernel(prof, steps)
        prof_dev = sum(by_name.values())
        if not prof_dev:
            fail(f"profile: {tag}{name}: torch.profiler saw no kernel in "
                 f"{steps} replays")
        seen = _kernel_launches(prof, "paged_attention_kernel")
        counted = steps * sum(n for n, _ in unit.replay_launches.values())
        if ran != counted:
            fail(f"profile: {tag}{name}: the paged kernel ran {ran} times "
                 f"on the card in {steps} replays, the unit counts "
                 f"{counted} (captured: {unit.replay_launches})")
        res[name] = {"wall_ms": wall, "device_ms": dev, "by_name": by_name,
                     "kernels": _kernel_launches(prof, "") / steps}
        top = "; ".join(f"{n[:48]} {ms:.2f}" for n, ms in
                        by_name.most_common(6))
        per = (f" = {wall / SERVE_SPAN:.2f} / {dev / SERVE_SPAN:.2f} a "
               f"decode step" if name == "decode_span" else "")
        print(f"[profile] {tag}{name} (graph replay) B={B} kv=128: wall "
              f"{wall:.2f} ms, device {dev:.2f} ms (CUDA events, "
              f"{dev / wall:.0%} busy){per}; torch.profiler over replays: "
              f"{prof_dev:.2f} device ms; paged kernel launches run on "
              f"the card {ran} = {steps} x captured (profiler events "
              f"{seen}), top kernels (ms per call): {top}",
              flush=True)
    _unit_report(srv, f"{tag}profile server")
    del srv
    g = torch.Generator(device=DEVICE).manual_seed(6)
    lg2 = torch.randn((B, cfg.vocab_size), generator=g, device=DEVICE)
    lg3 = torch.randn((B, VERIFY_K + 1, cfg.vocab_size), generator=g,
                      device=DEVICE)
    lg2, lg3 = lg2.to(torch.bfloat16), lg3.to(torch.bfloat16)
    st = tuple(torch.as_tensor(a, device=DEVICE) for a in samp)
    pos = torch.full((B,), 128, dtype=torch.int32, device=DEVICE)
    ix3 = pos[:, None] + 1 + torch.arange(VERIFY_K + 1, dtype=torch.int32,
                                          device=DEVICE)[None, :]
    heads = {
        "sample head [8, V]": lambda: sampling.sample_tokens(
            lg2, *st, pos + 1),
        f"sample head [8, {VERIFY_K + 1}, V]": lambda: sampling.sample_tokens(
            lg3, *st, ix3),
    }
    for name, fn in heads.items():
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / steps * 1e3
        with _device_profile() as prof:
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
        by_name = _device_ms_by_kernel(prof, steps)
        dev = sum(by_name.values())
        print(f"[profile] {tag}{name} B={B}: eager wall {wall:.2f} ms, "
              f"device {dev:.2f} ms (profiler, {len(by_name)} kernel names)"
              f"; as a graph replay {_graph_ms(fn, steps):.3f} device ms",
              flush=True)
    return res


# ----------------------------------------------------------------------
# 7. served tokens against the plain path on a small input
# ----------------------------------------------------------------------

def _serve_recording(srv, reqs) -> dict:
    """Serve `reqs` on `srv`, recording every occupied slot's logits at
    every sample-head call (chunk, span and verify heads) under (rid,
    index of the output token drawn at that row's emission position),
    with the call's number.  A verify call records each of its rows;
    a later call's record of a position is the one that emitted it.
    Slots mid-prompt get negative indices, finished slots indices past
    their output: neither is read.  The rows stay on the device until
    the wave ends (no host read inside it).  The units run through
    their eager calls (a graph replay calls no Python), which give the
    graph replays' tokens bit for bit (phases 5 and 5b)."""
    from repro_torch.models import sampling
    calls = []
    orig = sampling.sample_tokens
    _eager_units(srv)

    def spy(logits, temp, top_k, top_p, seed, index):
        calls.append(([r.rid if r is not None else None
                       for r in srv.slot_req], {r.rid: len(r.prompt)
                                                for r in srv.slot_req
                                                if r is not None},
                      logits.detach().clone(), index.clone()))
        return orig(logits, temp, top_k, top_p, seed, index)

    sampling.sample_tokens = spy
    try:
        stats = srv.serve(reqs)
    finally:
        sampling.sample_tokens = orig
        _graph_units(srv)
    rec = {"steps": len(calls), "stats": stats}
    for n, (rids, plen, logits, index) in enumerate(calls, 1):
        index = index.cpu().reshape(logits.shape[0], -1)
        logits = logits.reshape(index.shape + logits.shape[-1:])
        for s_, rid in enumerate(rids):
            if rid is None:
                continue
            for j in range(index.shape[1]):
                rec[(rid, int(index[s_, j]) - plen[rid])] = (n, logits[s_, j])
    return rec


def _parting(a, b):
    """Index of the first token where streams a and b differ (None if
    equal; the shorter length if one is a prefix of the other)."""
    if a == b:
        return None
    n = min(len(a), len(b))
    return next((i for i in range(n) if a[i] != b[i]), n)


def _draw_margin(lg, sp, index) -> float:
    """How near a recorded draw is to another, in logit units
    (`sampling.draw_margins`: the top-2 gap, for sampled params of z + g
    and at the top-k cut, times the temperature)."""
    from repro_torch.models import sampling
    gap, _, kgap, _ = sampling.draw_margins(lg, sp, index)
    return min(gap, kgap) * (1.0 if sp.is_greedy else sp.temperature)


def phase_small(fp8: bool, arch: str = "yi-6b") -> None:
    """The reduced yi-6b (2 layers, d_model 64, G=2; phase 12: the
    reduced `arch`, bf16) served through the
    kernels on the card and through the plain versions on the CPU, with
    the same weights, greedy with decode spans and sampled with spec
    decode K=3 (verify steps through the chunk kernel, the warm wave of
    a spec server, whose table the cold wave taught; per-request
    temperature 0.8, top-k 20, seeds 500+i): card and CPU streams must
    be equal.  In bf16, on the card, spec K=3 must also equal K=0,
    greedy and sampled.  A stream may part only where the base run's
    own draw is within the margin of another (greedy: its top-2
    logits; sampled: the top two of z + g or the top-k cut, in logit
    units; the noise is integer-exact across devices, so a parting is
    logit rounding only).  With fp8 linears the activation scale is one
    per call over the whole batch (K=3 and K=0 batches differ, so they
    are not compared), and once a stream parts the other slots' inputs
    change: only the partings at the first parting step are held.  By
    the same rule: serve_online(closed_stream) on the card against the
    CPU's serve(), and in bf16 ChunkedServer(paged=False) and SlotServer
    on the card against the same on the CPU.  A moe model couples the
    rows of a call (capacity counts every row), as fp8 linears do: only
    the first parting step is held, and spec K=3 is not held to K=0
    (the verify and decode calls batch other rows)."""
    import dataclasses
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models import api
    from repro_torch.models.sampling import GREEDY, SamplingParams
    from repro_torch.runtime.arrivals import closed_stream
    from repro_torch.runtime.server import (ChunkedServer, SlotServer,
                                            clone_requests,
                                            sharegpt_like_requests)
    cfg = reduced_config(arch)
    if arch == "yi-6b":
        cfg = dataclasses.replace(cfg, num_kv_heads=2)
    cpu_params = api.init(cfg, 0, device="cpu")
    margin = SMALL_FP8_MARGIN if fp8 else SMALL_MARGIN
    tag = "fp8_kv + fp8 linears" if fp8 else "bf16"
    coupled = fp8 or cfg.family == "moe"
    model = ("reduced yi-6b (G=2)" if arch == "yi-6b"
             else f"reduced {arch} ({cfg.family}, "
                  f"G={cfg.num_heads // cfg.num_kv_heads})")

    def to(tree, device):
        if isinstance(tree, torch.Tensor):
            return tree.to(device)
        return {k: to(v, device) for k, v in tree.items()}

    card_params = to(cpu_params, DEVICE)
    reqs = sharegpt_like_requests(8, cfg.vocab_size, max_input=32,
                                  max_output=16, seed=0)
    greedy = lambda i: GREEDY                                   # noqa
    sampled = lambda i: SamplingParams(temperature=0.8,         # noqa
                                       top_k=20, seed=500 + i)

    def serve(device, k, samp, record, online=False, **kw):
        """One wave; with spec decode the second (warm) wave of a server
        whose table the first taught, so that drafts are accepted;
        `online` serves it through serve_online(closed_stream)."""
        params = cpu_params if device == "cpu" else card_params
        srv = ChunkedServer(cfg, params, batch_slots=4, max_len=56, chunk=8,
                            span=4, block_size=8, fp8_kv=fp8, fp8_linear=fp8,
                            spec_decode=k, device=device, **kw)
        for _ in range(2 if k else 1):
            rs = clone_requests(reqs)
            for i, r in enumerate(rs):
                r.sampling = samp(i)
            rec = _serve_recording(srv, rs) if record else None
            stats = (rec["stats"] if record
                     else srv.serve_online(closed_stream(rs)) if online
                     else srv.serve(rs))
        return [r.output for r in rs], stats, rec

    def slot_wave(device, record=False):
        """One wave on SlotServer; `record` keeps each slot's logits at
        its prefill and at every decode step (its argmax, on the host)
        under (rid, output index)."""
        srv = SlotServer(cfg, cpu_params if device == "cpu" else card_params,
                         batch_slots=4, max_len=56, device=device)
        rs, rec = clone_requests(reqs), {}
        if record:
            admit, run = srv.admit, srv._decode.run

            def recorded_admit(req, slot):
                lg = admit(req, slot)
                rec[(req.rid, 0)] = (len(rec) + 1, lg.detach().clone())
                return lg

            def recorded_run(*ops):
                out = run(*ops)
                for s_, r in enumerate(srv.slot_req):
                    if r is not None:
                        rec[(r.rid, len(r.output))] = (len(rec) + 1,
                                                       out[0][s_].clone())
                return out

            srv.admit, srv._decode.run = recorded_admit, recorded_run
        srv.serve(rs)
        return [r.output for r in rs], rec

    def held(label, base, rec, other, samp, stats):
        partings = []
        for i, (r, a, b) in enumerate(zip(reqs, base, other)):
            if len(a) != len(b):
                fail(f"small input {tag} {label}, request {r.rid}: "
                     f"{len(a)} and {len(b)} tokens")
            j = _parting(a, b)
            if j is not None:
                step, lg = rec[(r.rid, j)]
                partings.append((step, r.rid, j, lg, b[j], samp(i),
                                 len(r.prompt) + j))
        first = min((p[0] for p in partings), default=0)
        for step, rid, j, lg, tok, sp, index in partings:
            if coupled and step > first:
                continue
            gap = _draw_margin(lg, sp, index)
            off = float(lg.float().max() - lg.float()[tok])
            if gap > margin or (sp.is_greedy and off > margin):
                fail(f"small input {tag} {label}, request {rid}: streams "
                     f"part at token {j} where the base run's margin is "
                     f"{gap:.4f}")
        extra = (f"; {int(stats['spec_steps'])} verify steps, acceptance "
                 f"{stats['spec_acceptance_rate']:.3f}"
                 if "spec_steps" in stats else "")
        print(f"[small] {model} {tag} {label}: "
              f"{len(reqs) - len(partings)}/{len(reqs)} token streams "
              f"equal, {len(partings)} part "
              f"({sum(p[0] == first for p in partings)} at the first "
              f"parting step, each at a margin within {margin}){extra}",
              flush=True)

    cpu_g0, _, cpu_rec = serve("cpu", 0, greedy, True)
    card_g0, _, card_rec = serve(DEVICE, 0, greedy, not fp8)
    held("greedy, card kernels vs CPU plain", cpu_g0, cpu_rec, card_g0,
         greedy, {})
    # tensor-parallel: tp=2 on a mesh spread over the card (each shard's
    # kernels at KH/2 = 1 kv head) against the CPU's tp=1
    tp_mesh = (make_tp_mesh(2, spread=DEVICE)
               if arch == "yi-6b" and not fp8 else None)
    if tp_mesh is not None:
        card_t0, _, _ = serve(DEVICE, 0, greedy, False, mesh=tp_mesh)
        held("greedy tp=2, card kernels vs CPU plain tp=1", cpu_g0,
             cpu_rec, card_t0, greedy, {})
    card_o, _, _ = serve(DEVICE, 0, greedy, False, online=True)
    held("greedy serve_online(closed_stream) on the card vs CPU serve()",
         cpu_g0, cpu_rec, card_o, greedy, {})
    if not fp8:
        # neither takes an e4m3 pool
        cpu_c, _, rec_c = serve("cpu", 0, greedy, True, paged=False)
        card_c, _, _ = serve(DEVICE, 0, greedy, False, paged=False)
        held("greedy contiguous, card vs CPU", cpu_c, rec_c, card_c, greedy,
             {})
        cpu_sl, rec_sl = slot_wave("cpu", record=True)
        held("slot baseline, card vs CPU", cpu_sl, rec_sl,
             slot_wave(DEVICE)[0], greedy, {})
    cpu_s3, _, cpu_rec = serve("cpu", 3, sampled, True)
    card_s3, st, _ = serve(DEVICE, 3, sampled, False)
    held("sampled spec K=3, card kernels vs CPU plain", cpu_s3, cpu_rec,
         card_s3, sampled, st)
    if tp_mesh is not None:
        card_t3, st, _ = serve(DEVICE, 3, sampled, False, mesh=tp_mesh)
        held("sampled spec K=3 tp=2, card kernels vs CPU plain tp=1",
             cpu_s3, cpu_rec, card_t3, sampled, st)
    if not coupled:
        card_g3, st, _ = serve(DEVICE, 3, greedy, False)
        held("greedy on the card, spec K=3 vs K=0", card_g0, card_rec,
             card_g3, greedy, st)
        card_s0, _, card_rec = serve(DEVICE, 0, sampled, True)
        held("sampled on the card, spec K=3 vs K=0", card_s0, card_rec,
             card_s3, sampled, {})


# ----------------------------------------------------------------------
# 15. tensor-parallel serving on a mesh spread over the card
# ----------------------------------------------------------------------

# the tp phase's server and wave: 8 slots; 12 system-prompt requests
# (two 40-token templates, not block aligned: later admissions share a
# finished request's prefix and copy its last block on write)
TP_SERVER = dict(batch_slots=8, chunk=16, span=8, block_size=16,
                 max_len=64 + 32 + 8, prefix_cache=True)
TP_SPEC_K = 4
TP_REPLAYS = 20                 # replays a device-ms reading


def _tp_wave(cfg):
    from repro_torch.runtime.server import sysprompt_sharegpt_requests
    return sysprompt_sharegpt_requests(
        12, cfg.vocab_size, num_templates=2, template_len=40, max_input=64,
        max_output=32, seed=7)


def _tp_server(cfg, params, tp: int, **kw):
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.runtime.server import ChunkedServer
    if tp == 1:
        return ChunkedServer(cfg, params, device=DEVICE, **TP_SERVER, **kw)
    return ChunkedServer(cfg, params, mesh=make_tp_mesh(tp, spread=DEVICE),
                         **TP_SERVER, **kw)


def _tree_nbytes(caches) -> int:
    return sum(t.numel() * t.element_size() for c in caches
               for t in c.values())


def _replay_ms(unit) -> float:
    """Device ms of one replay of `unit`'s graph (CUDA events around
    TP_REPLAYS back-to-back replays on its last operands)."""
    import torch
    if unit.graph is None:
        return None                      # called once: never captured
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TP_REPLAYS):
        unit.graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / TP_REPLAYS


def phase_tp(cfg, params) -> dict:
    """ChunkedServer(mesh=make_tp_mesh(tp, spread="cuda")) on full-width
    yi-6b (phase 5's depth): tp = 1, 2, 4 on one seeded wave with a
    paged bf16 pool, the prefix cache and spec decode K=4; then tp=2
    against tp=1 with an e4m3 pool (the reference's tp combo) and
    sampled (temperature 0.8, top-k 20, seeds 600+i), both without spec
    decode, so decode spans run too.  Each stream's first parting from
    tp=1's is printed with tp=1's margin there, not held: the random
    deep stack is chaotic (a one-rounding difference of one layer's
    column-split products, which cuBLAS forms with other kernels at
    other N, grows to O(1) logits: `_tp_one_layer`'s readings), as
    between other unit shapes (ROADMAP, queue C's "not faults").  Held:
    one layer's chunk, decode and verify steps at tp=2 and tp=4 against
    tp=1 on the same inputs (`_tp_one_layer`); every unit one program,
    captured once; the tp=2
    graphs equal a tp=2 server's eager units bit for bit (streams and
    every position's pools); the paged kernels launched tp x L times a
    chunk, verify and span step, as many run on the card; each
    position's pool 1/tp of tp=1's bytes and KV heads.  Printed (a
    record, not a claim): tokens/s and the verify and span steps'
    device ms at each tp.  Returns the tp waves' launches by kernel and
    by body (each wave's counted from 0 around it)."""
    import gc
    import torch
    from repro_torch.kernels import paged_attention as pk
    from repro_torch.models.sampling import GREEDY, SamplingParams
    from repro_torch.runtime.server import clone_requests
    t_phase = time.perf_counter()
    L = cfg.num_layers
    reqs = _tp_wave(cfg)
    sampled = lambda i: SamplingParams(temperature=0.8,           # noqa
                                       top_k=20, seed=600 + i)
    greedy = lambda i: GREEDY                                     # noqa
    total = {k: 0 for k in pk.launch_counts()}
    bodies = {k: {b: 0 for b in pk.BODIES} for k in total}

    def wave(samp):
        rs = clone_requests(reqs)
        for i, r in enumerate(rs):
            r.sampling = samp(i)
        return rs

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    def base_run(samp, **kw):
        """tp=1 through its eager units, recording every draw's logits
        (eager units give the graphs' tokens bit for bit, phase 5)."""
        srv = _tp_server(cfg, params, 1, **kw)
        rs = wave(samp)
        rec = _serve_recording(srv, rs)
        nbytes = _tree_nbytes([srv.cache])
        del srv
        free()
        return [r.output for r in rs], rec, nbytes

    def tp_run(tp, samp, label, eager=False, **kw):
        """One wave at `tp` through graphs (or eager units), its kernel
        launches counted from 0 around it; checks launches and
        programs.  Returns (streams, stats, server)."""
        srv = _tp_server(cfg, params, tp, **kw)
        if eager:
            _eager_units(srv)
        rs = wave(samp)
        by_unit = _count_units(srv)
        ran0 = pk.device_launches(DEVICE)
        pk.reset_launch_counts()              # this path starts here
        st = srv.serve(rs)
        launches = srv.launch_counts()        # and ends here
        by_body = pk.launches_by_body()
        _uncount_units(srv)
        _check_ran(f"tp {label}", pk.device_launches(DEVICE) - ran0,
                   launches)
        for k, n in launches.items():
            total[k] += n
            for b, m in by_body[k].items():
                bodies[k][b] += m
        f8 = "_fp8" if kw.get("fp8_kv") else ""
        verify = int(st.get("spec_steps", 0))
        spans = int(st["decode_spans"]) - verify
        want = {f"paged_chunk{f8}": tp * L * (int(st["chunk_steps"])
                                              + verify),
                f"paged_decode{f8}": tp * L * spans * srv.span}
        got = {k: launches[k] for k in want}
        units = {u: dict(c) for u, c in by_unit.items() if u != "emitted"}
        if got != want or by_unit["chunk"][f"paged_chunk{f8}"] != \
                tp * L * int(st["chunk_steps"]) or \
                sum(launches.values()) != sum(got.values()):
            fail(f"tp {label}: launches {launches}, by unit {units}, not "
                 f"tp x L x steps {want}")
        _unit_report(srv, f"tp {label}", eager=eager)
        for r in rs:
            want_n = min(r.max_new, srv.max_len - len(r.prompt))
            if not r.done or len(r.output) != want_n:
                fail(f"tp {label} request {r.rid}: {len(r.output)} tokens, "
                     f"expected {want_n}")
        print(f"[tp] {label}: {int(st['tokens'])} tokens in "
              f"{st['seconds']:.3f} s = {st['tokens_per_s']:.1f} tok/s; "
              f"chunk steps {int(st['chunk_steps'])}, verify steps "
              f"{verify}, spans {spans}; prefix hits "
              f"{int(st['prefix_hit_requests'])}, cow resolves "
              f"{srv.metrics.counter_value('serving.cow.resolves')}; "
              f"launches {got} (tp x L x steps, as many on the card); KV "
              f"bytes per position {int(st['kv_bytes_per_device'])}",
              flush=True)
        return [r.output for r in rs], st, srv

    def printed(label, base, rec, other, samp):
        partings = []
        for i, (r, a, b) in enumerate(zip(reqs, base, other)):
            j = _parting(a, b)
            if j is not None:
                step, lg = rec[(r.rid, j)]
                partings.append((step, r.rid, j, lg, samp(i),
                                 len(r.prompt) + j))
        first = min((p[0] for p in partings), default=0)
        for step, rid, j, lg, sp, index in partings:
            print(f"[tp]   {label}: request {rid} parts at token {j} "
                  f"(step {step}{', the first' if step == first else ''}); "
                  f"tp=1 margin there {_draw_margin(lg, sp, index):.4f} "
                  f"(|logit| <= {float(lg.float().abs().max()):.2f})",
                  flush=True)
        print(f"[tp] {label}: {len(reqs) - len(partings)}/{len(reqs)} "
              f"streams equal tp=1's, {len(partings)} part (printed, not "
              f"held)", flush=True)
        return len(partings)

    def pools(label, srv, tp, base_bytes):
        per = [_tree_nbytes([c]) for c in srv.cache]
        heads = {c["k"].shape[3] for c in srv.cache}
        if any(p * tp != base_bytes for p in per) or heads != {
                cfg.num_kv_heads // tp}:
            fail(f"tp {label}: pool bytes per position {per} (KV heads "
                 f"{heads}) are not 1/{tp} of tp=1's {base_bytes}")
        if not all(t.is_contiguous() for c in srv.cache for t in c.values()):
            fail(f"tp {label}: a position's pool is not dense")
        print(f"[tp] {label}: pool bytes per position {per} = 1/{tp} of "
              f"tp=1's {base_bytes}, {heads.pop()} KV heads each",
              flush=True)

    spec = dict(spec_decode=TP_SPEC_K)
    one_layer = _tp_one_layer(cfg, params)
    timing, parted = {}, {}
    # greedy, spec decode K=4, at tp = 1, 2, 4
    base, rec, base_bytes = base_run(greedy, **spec)
    outs = {}
    for tp in (1, 2, 4):
        label = f"tp={tp} bf16 spec K={TP_SPEC_K}"
        outs[tp], st, srv = tp_run(tp, greedy, label, **spec)
        if tp == 2:                 # before the timing replays write it
            graph_cache = [{k: t.clone() for k, t in c.items()}
                           for c in srv.cache]
        timing[f"tp{tp}"] = {"tokens_per_s": st["tokens_per_s"],
                             "verify_step_device_ms":
                                 _replay_ms(srv._units["verify_step"])}
        if tp > 1:
            pools(label, srv, tp, base_bytes)
        del srv
        free()
        parted[label] = printed(f"{label} vs tp=1", base, rec, outs[tp],
                                greedy)
    if outs[1] != base:
        fail("tp=1 graph streams differ from its eager units'")
    eager_out, _, eager_srv = tp_run(
        2, greedy, f"tp=2 bf16 spec K={TP_SPEC_K}, eager units",
        eager=True, **spec)
    same_out = eager_out == outs[2]
    same = same_out and all(
        torch.equal(a[k].view(torch.uint8), b[k].view(torch.uint8))
        for a, b in zip(graph_cache, eager_srv.cache) for k in a)
    print(f"[tp] tp=2 graph replays {'equal' if same else 'DIFFER FROM'} "
          f"its eager units bit for bit (streams "
          f"{'equal' if same_out else 'differ'}; both positions' pools)",
          flush=True)
    if not same:
        fail("tp=2 graph replays differ from eager units")
    del eager_srv, graph_cache
    free()
    # an e4m3 pool, then sampled, at tp=2 (no spec: chunk and span steps)
    for label, samp, kw in (("e4m3 pool", greedy, dict(fp8_kv=True)),
                            ("sampled", sampled, {})):
        base, rec, base_bytes = base_run(samp, **kw)
        out2, st, srv = tp_run(2, samp, f"tp=2 {label}", **kw)
        pools(f"tp=2 {label}", srv, 2, base_bytes)
        span_ms = _replay_ms(srv._units["decode_span"])
        timing[f"tp2 {label}"] = {
            "tokens_per_s": st["tokens_per_s"],
            "span_step_device_ms": span_ms and span_ms / srv.span}
        del srv
        free()
        parted[f"tp=2 {label}"] = printed(f"tp=2 {label} vs tp=1", base,
                                          rec, out2, samp)
    print(f"[tp] record (one card: the split adds launches and gathers, "
          f"nothing is expected to get faster): {timing}", flush=True)
    for k in total:
        if total[k] <= 0:
            fail(f"tp phase: {k} never launched: {total}")
    secs = time.perf_counter() - t_phase
    print(f"[tp] phase {secs:.1f} s; streams parted from tp=1 {parted}; "
          f"launches {total}, by body {bodies}", flush=True)
    return {"launches": total, "by_body": bodies, "timing": timing,
            "parted": parted, "one_layer": one_layer, "seconds": secs}


def _tp_one_layer(cfg, params) -> dict:
    """One layer of full-width yi-6b (the first of `params`), tp = 2 and
    4 against tp=1 on the same inputs: a chunk step (B=8, C=16 from
    position 0), a decode step and a verify step (C=5) after it, on
    bf16 pools.  Each step's logits are held within the bf16 rule at
    their magnitude (`_spec_margin`: max(SMALL_MARGIN, 2**-5 max
    |logit|)), and the pools, joined over the positions' KV heads,
    within one bf16 step (2**-7) of their largest |value|: the shards'
    products round once differently where cuBLAS picks another kernel
    for a narrower N (measured: wk's 512 columns against 256 and 128).
    Returns the readings."""
    import dataclasses
    import torch
    from repro_torch.launch.mesh import make_tp_mesh
    from repro_torch.models import api, convert
    c1 = dataclasses.replace(cfg, num_layers=1)

    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[:1]

    p1 = dict(params, layers=first(params["layers"]))
    g = torch.Generator(device=DEVICE).manual_seed(15)
    B, C, K = 8, 16, 5
    toks = torch.randint(0, cfg.vocab_size, (B, C + K), generator=g,
                         device=DEVICE, dtype=torch.int32)
    bt = torch.arange(B * 4, dtype=torch.int32, device=DEVICE).reshape(B, 4)
    pos = torch.zeros(B, dtype=torch.int32, device=DEVICE)
    n = torch.full((B,), C, dtype=torch.int32, device=DEVICE)

    def steps(params_, mesh):
        cache = api.init_cache(c1, B, 64, block_size=16, num_blocks=B * 4,
                               device=DEVICE, mesh=mesh)
        kw = {} if mesh is None else {"mesh": mesh}
        out = [api.chunk_step(c1, params_, cache, toks[:, :C], pos, n, bt,
                              kernel=True, **kw)[0]]
        out.append(api.decode_step(c1, params_, cache, toks[:, C], pos + C,
                                   bt, kernel=True, **kw)[0])
        h = api.verify_step(c1, params_, cache, toks[:, C:], pos + C, bt,
                            kernel=True, **kw)
        caches = cache if isinstance(cache, list) else [cache]
        pools = {k: torch.cat([c[k] for c in caches], dim=3)
                 for k in ("k", "v")}
        return out, h[0], pools

    base, base_v, base_pools = steps(p1, None)
    readings = {}
    for tp in (2, 4):
        mesh = make_tp_mesh(tp, spread=DEVICE)
        got, got_v, pools = steps(convert.shard_params(p1, c1, mesh), mesh)
        errs = [float((a.float() - b.float()).abs().max())
                for a, b in zip(base, got)]
        rules = [_spec_margin(a) for a in base]
        perr = {k: float((base_pools[k].float() - pools[k].float())
                         .abs().max()) for k in pools}
        prule = {k: 2.0 ** -7 * float(base_pools[k].float().abs().max())
                 for k in pools}
        vtok = float((got_v == base_v).float().mean())
        print(f"[tp] one layer, tp={tp} vs tp=1: chunk / decode logits max "
              f"|diff| {errs[0]:.5f} / {errs[1]:.5f} (rules {rules[0]:.4f} "
              f"/ {rules[1]:.4f}); pools max |diff| {perr} (one bf16 step "
              f"of the largest {prule}); verify tokens equal "
              f"{vtok:.3f}", flush=True)
        if any(e > r for e, r in zip(errs, rules)) or any(
                perr[k] > prule[k] for k in perr):
            fail(f"tp={tp}: one layer's logits or pools off tp=1's beyond "
                 f"the bf16 rule")
        readings[f"tp{tp}"] = {"chunk": errs[0], "decode": errs[1],
                               "pools": perr, "verify_tokens_equal": vtok}
    return readings


# ----------------------------------------------------------------------
# 8. tensor cores and async copy (paper Tables VI-XI, XIII/XIV)
# ----------------------------------------------------------------------

# yi-6b's MLP up-projection for a 2048-token prefill: M tokens, K
# d_model, N d_ff
FULL_WIDTH = (2048, 11008, 4096)
# max |kernel - plain| over max |plain|: float32 outputs (and float32
# outputs of bf16 products) differ only in the order of the float32
# sums, a few float32 roundings; bf16 outputs round the same float32
# sum, so at most one bf16 step (2**-7 of the value); integers exact
MM_REL_LIMIT = {"float32": 1e-5, "bfloat16": 2.0 ** -7, "int32": 0.0}
H100_SMS = 132      # streaming multiprocessors of an H100 SXM


def _mm_inputs(dtype_name, M, N, K, seed):
    import torch
    g = torch.Generator(device=DEVICE).manual_seed(seed)
    if dtype_name == "int8":
        return [torch.randint(-8, 8, shape, generator=g, device=DEVICE,
                              dtype=torch.int8) for shape in ((M, K), (K, N))]
    return [torch.randn(shape, generator=g, device=DEVICE).to(
        getattr(torch, dtype_name)) for shape in ((M, K), (K, N))]


def _mm_library(dtype_name, a, b, sx=None, sw=None):
    """One PyTorch call computing the same product (a yardstick the port
    never calls), or None where PyTorch has none for these inputs:
    torch.matmul (TF32 off), torch._scaled_mm for e4m3, torch._int_mm
    for int8 where its shape rules allow."""
    import torch
    if dtype_name == "float8_e5m2":
        return None                     # _scaled_mm refuses e5m2 x e5m2
    if dtype_name == "float8_e4m3fn":
        bt = b.t().contiguous().t()     # column-major, made untimed
        sx = sx.reshape(()).contiguous()
        sw = sw.reshape(()).contiguous()
        fn = lambda: torch._scaled_mm(a, bt, scale_a=sx, scale_b=sw,
                                      out_dtype=torch.bfloat16)
    elif dtype_name == "int8":
        fn = lambda: torch._int_mm(a, b)
    else:
        fn = lambda: torch.matmul(a, b)
    try:
        fn()
        torch.cuda.synchronize()
    except RuntimeError:
        return None
    return fn


def _mm_bound(dtype_name, M, N, K, in_elt, out_elt):
    """Least time for the product: 2MNK operations at the dtype's peak
    (hw.H100_SXM), or A and B read once and C written once at 3.35 TB/s,
    whichever is longer."""
    from repro_torch.core import hw
    t_ops = 2.0 * M * N * K / hw.H100_SXM.peak_for(dtype_name) * 1e3
    nbytes = (M * K + K * N) * in_elt + M * N * out_elt
    t_bytes = nbytes / (hw.H100_SXM.hbm_gbps * 1e9) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def probe_native_fp8_mma() -> None:
    """A finding, not a gate: does the native e4m3 mma.sync (m16n8k32)
    compile for sm_90a (csrc/fp8_mma_probe.cu) and compute a 16x8x32
    product equal to the plain one (exact products, float32 sums)?"""
    import ctypes
    import torch
    from repro_torch.kernels import build
    try:
        path, _, _ = build.compile_source("fp8_mma_probe.cu")
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if "rror" in ln]
        print(f"[matmul] native e4m3 mma.sync m16n8k32 on sm_90a: nvcc "
              f"refused it: {lines[0].strip() if lines else e}", flush=True)
        return
    fn = ctypes.CDLL(str(path)).fp8_mma_probe
    fn.argtypes = [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    g = torch.Generator(device=DEVICE).manual_seed(0)
    a = torch.randn((16, 32), generator=g, device=DEVICE).to(
        torch.float8_e4m3fn)
    b = torch.randn((32, 8), generator=g, device=DEVICE).to(
        torch.float8_e4m3fn)
    c = torch.empty((16, 8), device=DEVICE)
    err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    if err:
        print(f"[matmul] native e4m3 mma.sync m16n8k32 on sm_90a: compiled, "
              f"launch failed with CUDA error {err}", flush=True)
        return
    diff = (c - a.float() @ b.float()).abs().max().item()
    print(f"[matmul] native e4m3 mma.sync m16n8k32 on sm_90a: compiled and "
          f"ran; max |C - plain| = {diff:.3e}", flush=True)


def probe_wgmma() -> None:
    """A finding, not a gate: do wgmma_common.cuh's TMA maps, mbarrier
    and descriptors compute a product (csrc/wgmma_probe.cu: one
    warpgroup, A [64,64] and B [64,128] bf16 by TMA, four m64n128k16
    with B MN-major)?  Run with B's leading and stride byte offsets as
    the kernels set them (8192: the next 64-column block, 1024: the next
    8 rows of K) and swapped, which should be wrong."""
    import ctypes
    import torch
    from repro_torch.kernels import build
    try:
        path, _, _ = build.compile_source("wgmma_probe.cu")
    except RuntimeError as e:
        print(f"[matmul] wgmma probe: nvcc refused it: {e}", flush=True)
        return
    fn = ctypes.CDLL(str(path)).wgmma_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    g = torch.Generator(device=DEVICE).manual_seed(0)
    a = torch.randn((64, 64), generator=g, device=DEVICE).bfloat16()
    b = torch.randn((64, 128), generator=g, device=DEVICE).bfloat16()
    want = a.float() @ b.float()
    for lbo, sbo in ((8192, 1024), (1024, 8192)):
        c = torch.zeros((64, 128), device=DEVICE)
        err = fn(a.data_ptr(), b.data_ptr(), c.data_ptr(), lbo, sbo,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        diff = (c - want).abs().max().item()
        print(f"[matmul] wgmma probe (TMA + mbarrier + m64n128k16 bf16, B "
              f"MN-major) LBO={lbo} SBO={sbo}: launch error {err}, "
              f"max |C - plain| = {diff:.3e} (max |plain| "
              f"{want.abs().max().item():.4g})", flush=True)


def probe_tma_f32() -> None:
    """A finding, not a gate: do tma_common.cuh's float32 tensor maps and
    its swizzle() agree with the hardware (csrc/tma_probe.cu: one TMA
    box under 128B, 64B, 32B and no swizzle, read back through
    swizzle())?"""
    import ctypes
    import torch
    from repro_torch.kernels import build
    try:
        path, _, _ = build.compile_source("tma_probe.cu")
    except RuntimeError as e:
        print(f"[matmul] float32 TMA probe: nvcc refused it: {e}", flush=True)
        return
    fn = ctypes.CDLL(str(path)).tma_probe
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    src = torch.arange(100 * 40, dtype=torch.float32, device=DEVICE).view(
        100, 40)
    for cols in (32, 16, 8, 4):
        out = torch.full((64, cols), -1.0, device=DEVICE)
        err = fn(src.data_ptr(), out.data_ptr(), 100, 40, 64, cols,
                 torch.cuda.current_stream().cuda_stream)
        torch.cuda.synchronize()
        wrong = int((out != src[:64, :cols]).sum())
        print(f"[matmul] float32 TMA probe, box 64 x {cols} ({cols * 4}-byte "
              f"rows): launch error {err}, {wrong} of {64 * cols} values "
              f"read back wrong through swizzle()", flush=True)


def probe_fp8_promotion() -> None:
    """A finding, not a gate: how far the e4m3 wgmma body lands from
    the plain product at the full-width shape (K=4096) with and without
    promoting each 128 values of K into the float32 accumulator.  The
    variant without it is built from a copy of the sources in the build
    directory whose OpFP8 says kPromote = false; the port has no such
    switch."""
    import ctypes
    import shutil
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import fp8_matmul as f8k
    work = build.BUILD_DIR / "fp8_no_promotion"
    work.mkdir(parents=True, exist_ok=True)
    for src in ["fp8_matmul.cu", *(p.name for p in build.CSRC.glob("*.cuh"))]:
        shutil.copy(build.CSRC / src, work / src)
    hdr = work / "wgmma_common.cuh"
    text = hdr.read_text()
    promote = "static constexpr bool kPromote = true;"
    if text.count(promote) != 1:
        print("[matmul] fp8 promotion probe: the header's OpFP8 changed; "
              "skipped", flush=True)
        return
    hdr.write_text(text.replace(promote,
                                "static constexpr bool kPromote = false;"))
    lib_path = work / "fp8_matmul_no_promotion.so"
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o",
                           str(lib_path), str(work / "fp8_matmul.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        print(f"[matmul] fp8 promotion probe: nvcc failed: "
              f"{proc.stderr[-300:]}", flush=True)
        return
    fn = ctypes.CDLL(str(lib_path)).fp8_matmul_fwd
    fn.argtypes = list(build.SIGNATURES["fp8_matmul.cu"]["fp8_matmul_fwd"])
    fn.restype = ctypes.c_int
    M, N, K = FULL_WIDTH
    a, b = _mm_inputs("float32", M, N, K, seed=7)
    a, b = a.to(torch.float8_e4m3fn), b.to(torch.float8_e4m3fn)
    bt = b.t().contiguous()
    sx = torch.tensor([0.37], device=DEVICE)
    sw = torch.tensor([1.9], device=DEVICE)
    want = f8k.fp8_matmul_plain(a, b, sx, sw).double()
    scale = want.abs().max().item()
    fast = torch.empty((M, N), dtype=torch.bfloat16, device=DEVICE)
    err = fn(0, a.data_ptr(), bt.data_ptr(), sx.data_ptr(), sw.data_ptr(),
             fast.data_ptr(), M, N, K, 128, 128, 128, 1,
             torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    promoted = f8k.fp8_matmul(a, bt.t(), sx, sw, bm=128, bn=128, bk=128)
    torch.cuda.synchronize()
    for name, got in (("promoted every 128 of K", promoted),
                      ("not promoted (variant)", fast)):
        d = (got.double() - want).abs()
        steps = (d > 2.0 ** -7 * want.abs() + 2.0 ** -12 * scale).sum()
        print(f"[matmul] fp8 e4m3 wgmma M={M} N={N} K={K}, {name}: launch "
              f"error {err if got is fast else 0}, max |C - plain| = "
              f"{d.max().item():.4e} ({d.max().item() / scale:.3e} of max "
              f"|plain| {scale:.4g}), mean {d.mean().item():.4e}, "
              f"{int(steps)} of {M * N} outputs beyond one bf16 step",
              flush=True)


def _body_of(kernel, dt, m, n, k, kw, a, b) -> str:
    """The body a product case runs by the rule's Python mirror
    (kernels/matmul.py `body` / `single_tile_body`,
    kernels/async_pipeline.py `body`), held to the source's own rule
    (`matmul_body`, `fp8_matmul_body`, `single_tile_matmul_body`,
    `pipelined_matmul_body`)."""
    import torch
    from repro_torch.kernels import async_pipeline as apk
    from repro_torch.kernels import build
    from repro_torch.kernels import matmul as mmk
    dtype = getattr(torch, dt)
    if kernel == "single_tile_matmul":
        ok = mmk.aligned(a, b, False)
        name = mmk.single_tile_body(dtype, m, n, k, ok)
        code = build.load("matmul.cu").single_tile_matmul_body(
            mmk._DTYPES[dtype], m, n, k, int(ok))
        names = mmk.SINGLE_BODIES
    elif kernel == "pipelined_matmul":
        ok = mmk.aligned(a, b, False)
        tiles = (kw["bm"], kw["bn"], kw["bk"])
        name = apk.body(m, n, k, *tiles, ok)
        code = build.load("async_pipeline.cu").pipelined_matmul_body(
            m, n, k, *tiles, int(ok))
        names = apk.BODIES
    else:
        layout = mmk.b_layout(kernel, b, dtype.itemsize == 1)
        # (A off 16 bytes is a case of the alignment rule, B as it is)
        tiles = (kw["bm"], kw["bn"], kw["bk"])
        ok = mmk.aligned(a, b,
                         copied_b=layout == "row" and dtype.itemsize == 1)
        name = mmk.body(dtype, m, n, k, *tiles, layout, ok)
        if kernel == "matmul":
            code = build.load("matmul.cu").matmul_body(
                mmk._DTYPES[dtype], m, n, k, *tiles, int(ok))
        else:
            code = build.load("fp8_matmul.cu").fp8_matmul_body(
                m, n, k, *tiles, int(ok))
        names = mmk.BODIES
    if names[code] != name:
        fail(f"{kernel} {dt} {(m, n, k)} {kw}: the source's rule says "
             f"{names[code]}, its Python mirror {name}")
    return name


def phase_matmul() -> tuple:
    """Each matrix-product kernel against its plain version on the card
    at the benchmarks' shapes and at yi-6b's full-width MLP
    up-projection (bf16 over a tile sweep, int8 and e4m3 with B
    column-major and contiguous, e5m2), each case's body printed and
    held to the tile rule, then the probes and the five dissection
    benchmarks through the kernels.  Returns (results keyed (kernel,
    case, dtype, (M, N, K), tiles), launch counts of the benchmark
    run)."""
    import torch
    from repro_torch.core import bench, hw
    from repro_torch.kernels import async_pipeline as apk
    from repro_torch.kernels import fp8_matmul as f8k
    from repro_torch.kernels import matmul as mmk
    from repro_torch.kernels import ops
    from repro_torch.benchmarks import run as _registers  # noqa: F401
    M, N, K = FULL_WIDTH
    e4m3, e5m2 = "float8_e4m3fn", "float8_e5m2"
    t128 = dict(bm=128, bn=128, bk=128)
    cases = []      # kernel, case, dtype, (M, N, K), kwargs, iters, B layout
    for dt in ("float32", "bfloat16", "int8"):
        for shape in ((128, 128, 128), (128, 256, 128), (256, 256, 256)):
            cases.append(("single_tile_matmul", "tc_mma", dt, shape, {}, 20,
                          "row"))
    for dt in ("float32", "bfloat16", "int8"):
        for bn in (128, 256):
            cases.append(("matmul", "tc_wgmma", dt, (512, 512, 512),
                          dict(bm=128, bn=bn, bk=128), 20, "row"))
    for bn in (32, 64, 128, 256):
        cases.append(("matmul", "tc_n_sweep", "float32", (256, 256, 256),
                      dict(bm=128, bn=bn, bk=128), 20, "row"))
    for dt in (e4m3, e5m2):
        cases.append(("fp8_matmul", "tc_wgmma", dt, (512, 512, 512), t128,
                      20, "row"))
    for bs in (16, 32, 64):
        for st in (1, 2, 3):
            cases.append(("pipelined_matmul", "async_copy", "float32",
                          (128, 64, 128),
                          dict(bm=bs, bn=min(bs, 64), bk=bs, stages=st), 20,
                          "row"))
    # float32 on the TMA ring (fma_tma) at both of its tiles, and the
    # same product with A off 16 bytes, which the rule sends to fma (PR
    # 13's body): the before and after of one call
    cases.append(("matmul", "full_width", "float32", (M, N, K), t128, 5,
                  "row"))
    cases.append(("matmul", "full_width", "float32", (M, N, K),
                  dict(bm=64, bn=64, bk=64), 5, "row"))
    cases.append(("matmul", "full_width_unalignedA", "float32", (M, N, K),
                  t128, 2, "unalignedA"))
    # bf16 over a tile sweep (the paper's Table X asked of wgmma)
    for bk in (128, 64):
        for bn in (64, 128, 256):
            cases.append(("matmul", "full_width", "bfloat16", (M, N, K),
                          dict(bm=128, bn=bn, bk=bk), 10, "row"))
    for tiles in (t128, dict(bm=128, bn=256, bk=128)):
        for layout in ("col", "row"):
            cases.append(("matmul", "full_width" + ("_rowB" * (
                layout == "row")), "int8", (M, N, K), tiles, 10, layout))
    for tiles in (t128, dict(bm=128, bn=128, bk=256)):
        for layout in ("col", "row"):
            cases.append(("fp8_matmul", "full_width" + ("_rowB" * (
                layout == "row")), e4m3, (M, N, K), tiles, 10, layout))
    cases.append(("fp8_matmul", "full_width", e5m2, (M, N, K), t128, 10,
                  "col"))
    # the public wrapper with auto tiles: the tile model's sweep on the
    # warpgroup grid (its earlier (128, 256, 128) ran mma_sync)
    for layout in ("col", "row"):
        cases.append(("ops.fp8_matmul", "full_width_auto" + ("_rowB" * (
            layout == "row")), e4m3, (M, N, K), {}, 10, layout))
    for bs in (64, 32, 16):
        for st in (1, 2, 3):
            cases.append(("pipelined_matmul", "full_width", "float32",
                          (M, N, K), dict(bm=bs, bn=bs, bk=bs, stages=st),
                          5 if bs == 64 else 2, "row"))
    # the ring matmul's fma_tma body runs, at 128 x 128: its two stages
    # of 64-float slices against four of 32
    for bk, st in ((64, 2), (32, 4)):
        cases.append(("pipelined_matmul", "full_width", "float32",
                      (M, N, K), dict(bm=128, bn=128, bk=bk, stages=st), 5,
                      "row"))
    fns = {"ops.fp8_matmul": (ops.fp8_matmul, f8k.fp8_matmul_plain),
           "matmul": (mmk.matmul, mmk.matmul_plain),
           "single_tile_matmul": (mmk.single_tile_matmul,
                                  mmk.single_tile_matmul_plain),
           "fp8_matmul": (f8k.fp8_matmul, f8k.fp8_matmul_plain),
           "pipelined_matmul": (apk.pipelined_matmul,
                                apk.pipelined_matmul_plain)}
    counters = {"matmul": mmk.matmul, "fp8_matmul": f8k.fp8_matmul,
                "ops.fp8_matmul": f8k.fp8_matmul,
                "single_tile_matmul": mmk.single_tile_matmul,
                "pipelined_matmul": apk.pipelined_matmul}
    results, inputs, plain_cache = {}, {}, {}
    for i, (kernel, case, dt, (m, n, k), kw, iters, layout) in \
            enumerate(cases):
        fn, plain_fn = fns[kernel]
        key_in = (dt, m, n, k)
        if key_in not in inputs:
            inputs.clear()
            plain_cache.clear()
            if dt.startswith("float8"):
                a, b = _mm_inputs("float32", m, n, k, seed=i)
                a, b = a.to(getattr(torch, dt)), b.to(getattr(torch, dt))
            else:
                a, b = _mm_inputs(dt, m, n, k, seed=i)
            inputs[key_in] = (a, b, {})
        a, b, views = inputs[key_in]
        if layout == "col":
            if "col" not in views:   # the same values, column-major
                views["col"] = b.t().contiguous().t()
            b = views["col"]
        if layout == "unalignedA":
            if "unalignedA" not in views:   # the same values, off 16 bytes
                buf = torch.empty(a.numel() + 1, dtype=a.dtype,
                                  device=DEVICE)
                views["unalignedA"] = buf[1:].view(a.shape)
                views["unalignedA"].copy_(a)
            a = views["unalignedA"]
        if kernel.endswith("fp8_matmul"):
            sx = torch.tensor([0.37], device=DEVICE)
            sw = torch.tensor([1.9], device=DEVICE)
            args = (a, b, sx, sw)
            lib = _mm_library(dt, a, b, sx, sw)
        else:
            args = (a, b)
            lib = _mm_library(dt, a, b)
        kern = lambda: fn(*args, **kw)
        plain = lambda: plain_fn(*args)
        if kernel == "ops.fp8_matmul":
            # the tiles the wrapper picks, named for the rule
            tiles = ops.product_tiles(m, n, k, getattr(torch, dt))
            body = _body_of("fp8_matmul", dt, m, n, k,
                            dict(zip(("bm", "bn", "bk"), tiles)), a, b)
            if body != "wgmma":
                fail(f"ops.fp8_matmul {dt} {(m, n, k)}: auto tiles {tiles} "
                     f"run {body}, not wgmma")
        else:
            body = _body_of(kernel, dt, m, n, k, kw, a, b)
        if kernel == "matmul" and dt == "float32" and \
                case.startswith("full_width"):
            want_body = "fma" if layout == "unalignedA" else "fma_tma"
            if body != want_body:
                fail(f"matmul float32 {case} {kw}: body {body}, the rule "
                     f"names {want_body}")
        before = dict(counters[kernel].body_launches)
        got = kern()
        torch.cuda.synchronize()
        if True:
            after = counters[kernel].body_launches
            ran = [x for x in after if after[x] != before.get(x, 0)]
            if ran != [body]:
                fail(f"{kernel} {case} {dt} {kw}: the rule names {body}, "
                     f"the call launched {ran}")
        if kernel not in plain_cache:
            plain_cache[kernel] = (plain(), _time_ms(plain, 3, warm=1))
        want, plain_ms = plain_cache[kernel]
        if got.dtype != want.dtype or got.shape != want.shape:
            fail(f"{kernel} {case} {dt}: {got.dtype} {tuple(got.shape)}, "
                 f"plain {want.dtype} {tuple(want.shape)}")
        if not torch.isfinite(got.float()).all():
            fail(f"{kernel} {case} {dt}: non-finite kernel output")
        out_name = str(got.dtype).replace("torch.", "")
        err = (got.double() - want.double()).abs().max().item()
        scale = want.double().abs().max().item()
        limit = MM_REL_LIMIT[out_name] * scale
        ms = _time_ms(kern, iters, warm=1)
        lib_ms = _time_ms(lib, iters, warm=1) if lib else None
        bound_ms, bound_by = _mm_bound(dt, m, n, k, a.element_size(),
                                       got.element_size())
        tfs = 2.0 * m * n * k / (ms * 1e-3) / 1e12
        # one block runs on one SM: its share of the card's peak
        one_sm = (2.0 * m * n * k / (hw.H100_SXM.peak_for(dt)
                                     / H100_SMS) * 1e3
                  if kernel == "single_tile_matmul" else None)
        sm_txt = f" one_sm_bound_ms={one_sm:.5f}" if one_sm else ""
        dev_ms = lib_dev_ms = None
        if kernel == "single_tile_matmul":
            # one block: back-to-back calls may wait on the host, so the
            # device time of a call is read from a graph replay too
            dev_ms = _graph_ms(kern, iters)
            lib_dev_ms = _graph_ms(lib, iters) if lib else None
            sm_txt += (f" device_ms={dev_ms:.4f} library_device_ms="
                       + (f"{lib_dev_ms:.4f}" if lib_dev_ms else "none"))
        tag = " ".join(f"{x}={y}" for x, y in kw.items())
        if kernel == "ops.fp8_matmul":
            tag = "auto " + " ".join(f"{x}={y}" for x, y in zip(
                ("bm", "bn", "bk"), tiles))
        ok = err <= limit
        lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
        copy_txt = ""
        if layout == "row" and body == "wgmma" and a.element_size() == 1:
            copy_ms = _time_ms(lambda: b.t().contiguous(), iters, warm=1)
            copy_txt = f" (B made K-major in the call: {copy_ms:.4f} ms)"
        print(f"[matmul] {kernel} {case} {dt} M={m} N={n} K={k} {tag} "
              f"B={layout} body={body}: "
              f"max_abs_err={err:.3e} (limit {limit:.3e} = "
              f"{MM_REL_LIMIT[out_name]:.3g} x max|plain| {scale:.4g}) "
              f"ms={ms:.4f}{copy_txt} plain_ms={plain_ms:.4f} "
              f"library_ms={lib_txt} "
              f"bound_ms={bound_ms:.5f} ({bound_by}){sm_txt} "
              f"TFLOP/s={tfs:.2f} "
              f"{'ok' if ok else 'OVER LIMIT'}", flush=True)
        if not ok:
            fail(f"{kernel} {case} {dt} {tag}: max abs error {err} over "
                 f"{limit}")
        results[(kernel, case, dt, (m, n, k), tag)] = {
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms, "body": body, "one_sm_bound_ms": one_sm,
            "device_ms": dev_ms, "library_device_ms": lib_dev_ms}
    inputs.clear()
    plain_cache.clear()
    probe_native_fp8_mma()
    probe_wgmma()
    probe_tma_f32()
    probe_fp8_promotion()
    for where, shape, bn_of in (("full width", FULL_WIDTH, lambda x: x),
                                ("async_copy shape", (128, 64, 128),
                                 lambda x: min(x, 64))):
        case = where.split()[0] if where == "full width" else "async_copy"
        case = "full_width" if case == "full" else case
        for bs in (64, 32, 16):
            t = {st: results[("pipelined_matmul", case, "float32", shape,
                              f"bm={bs} bn={bn_of(bs)} bk={bs} "
                              f"stages={st}")]["ms"]
                 for st in (1, 2, 3)}
            print(f"[matmul] {where}, block {bs}: SyncShare/AsyncPipe = "
                  f"{t[1] / t[2]:.3f}, SyncShare/AsyncPipe3 = "
                  f"{t[1] / t[3]:.3f} (paper H800: 1.395 at 8x8, 0.982 at "
                  f"32x32)", flush=True)
    new, new64, old = (
        results[("matmul", case, "float32", FULL_WIDTH, tag)]
        for case, tag in (("full_width", "bm=128 bn=128 bk=128"),
                          ("full_width", "bm=64 bn=64 bk=64"),
                          ("full_width_unalignedA", "bm=128 bn=128 bk=128")))
    print(f"[matmul] float32 full width: fma_tma 128^3 {new['ms']:.4f} ms, "
          f"64^3 {new64['ms']:.4f} ms; fma (A off 16 bytes) "
          f"{old['ms']:.4f} ms: {old['ms'] / new['ms']:.2f}x; torch.matmul "
          f"{new['library_ms']:.4f} ms: {new['ms'] / new['library_ms']:.2f}x "
          f"of it; bound {new['bound_ms']:.5f} ms", flush=True)
    # the five dissection benchmarks through the kernels: the main path
    # of this phase, with the counts set to 0 just before and read after
    torch.cuda.synchronize()
    for mod in (mmk, f8k, apk):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    bench.run_all(["tc_mma", "tc_wgmma", "tc_n_sweep", "tc_energy",
                   "async_copy"], fail_fast=True, device=torch.device(DEVICE))
    torch.cuda.synchronize()
    launches = {**mmk.launch_counts(), **f8k.launch_counts(),
                **apk.launch_counts()}
    print(f"[matmul] benchmarks ran in {time.perf_counter() - t0:.1f} s; "
          f"launch counts {launches}; bodies: matmul "
          f"{mmk.matmul.body_launches}, fp8_matmul "
          f"{f8k.fp8_matmul.body_launches}, single_tile_matmul "
          f"{mmk.single_tile_matmul.body_launches}, pipelined_matmul "
          f"{apk.pipelined_matmul.body_launches}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"a kernel of the dissection path was never launched: "
             f"{launches}")
    if mmk.matmul.body_launches["fma_tma"] <= 0:
        fail("the dissection benchmarks ran no float32 product on the "
             f"fma_tma body: {mmk.matmul.body_launches}")
    bodies = {"matmul": dict(mmk.matmul.body_launches),
              "fp8_matmul": dict(f8k.fp8_matmul.body_launches),
              "single_tile_matmul": dict(
                  mmk.single_tile_matmul.body_launches),
              "pipelined_matmul": dict(apk.pipelined_matmul.body_launches)}
    return results, launches, bodies


# ----------------------------------------------------------------------
# 9. DPX and distributed shared memory (paper Figs. 6-9)
# ----------------------------------------------------------------------

INT32_LANES_PER_SM = 64          # an H100 SM's int32 lanes a clock
# the full sizes: the DPX functions over 2**26 elements, the inner step
# of all-pairs shortest paths / Viterbi on a 2048-node graph, a
# short-read alignment batch plus one long pair, a 2**24-float ring,
# 2**26 values counted
DPX_N = 1 << 26
TROPICAL_FULL = 2048
SW_BATCH = (4096, 256, 256)
SW_LONG = (1, 1500, 1500)
# pairs past PR 14's shared-memory cap (La + 4 Lb above ~58000): a random
# one held against the plain version (~28000 diagonals of torch ops),
# and identical sequences whose score is match x length in closed form
SW_PAST_CAP = (1, 12000, 16000)
SW_IDENTICAL = 30000
RING_N = 1 << 24
HIST_N = 1 << 26
# 1024 / 4096 bins as the benchmark; 16384-65536 where a private
# histogram fills a block's shared memory (64, 128 KiB) or exceeds it
HIST_BINS = (1024, 4096, 16384, 32768, 65536)
# the cluster sizes the kernels take: 1 (no DSM) to 16 (non-portable)
CLUSTER_SIZES = (1, 2, 4, 8, 16)


def _int_rate() -> tuple:
    """(int32 instructions a second, SM clock in MHz): the card's SMs x
    64 lanes x its maximum SM clock (nvidia-smi clocks.max.sm)."""
    import torch
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    try:
        mhz = float(smi.stdout.strip().splitlines()[0])
    except (ValueError, IndexError):
        fail(f"nvidia-smi gave no maximum SM clock: {smi.stdout!r}")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6, mhz


def _ops_bound(instructions: float, nbytes: float, rate: float) -> tuple:
    """The larger of instructions over the int32 rate and bytes over
    3.35 TB/s, in ms, with what bounds it."""
    t_ops = instructions / rate * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _exact(kernel: str, tag: str, kern, plain, iters: int, bound: tuple,
           lib=None, extra: str = "") -> dict:
    """Kernel against plain on the same inputs: equal (bitwise for
    floats), then kernel ms over `iters` back-to-back calls, plain ms
    over one call after the checking one, and the library call's ms."""
    import torch
    got = kern()
    torch.cuda.synchronize()
    want = plain()
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{kernel} {tag}: {got.dtype} {tuple(got.shape)}, plain "
             f"{want.dtype} {tuple(want.shape)}")
    if got.dtype.is_floating_point:
        same = torch.equal(got.view(torch.int32), want.view(torch.int32))
        err = (got - want).abs().max().item()
    else:
        same = torch.equal(got, want)
        err = float((got.long() - want.long()).abs().max().item())
    del got, want
    ms = _time_ms(kern, iters, warm=1)
    plain_ms = _time_ms(plain, 1, warm=0)
    lib_ms = _time_ms(lib, iters, warm=1) if lib is not None else None
    bound_ms, bound_by = bound
    lib_txt = f"{lib_ms:.4f}" if lib_ms is not None else "none"
    print(f"[dpx_dsm] {kernel} {tag}: {'equal' if same else 'DIFFERENT'} "
          f"(max_abs_err={err:g}) ms={ms:.4f} plain_ms={plain_ms:.4f} "
          f"library_ms={lib_txt} bound_ms={bound_ms:.5f} ({bound_by}) "
          f"{ms / bound_ms:.1f}x bound{extra}", flush=True)
    if not same:
        fail(f"{kernel} {tag}: kernel and plain version differ")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


def _dpx_body(kernel, call) -> str:
    """The body of the one launch `call` makes, by the kernel's count."""
    import torch
    before = dict(kernel.launches_by_body)
    call()
    torch.cuda.synchronize()
    moved = [k for k, v in kernel.launches_by_body.items()
             if v != before[k]]
    if len(moved) != 1:
        fail(f"{kernel.__name__}: launches by body moved {moved}")
    return moved[0]


def _limit_ints(n: int, dtype, g):
    """n integers over the whole range of `dtype`, the first few at and
    next to its limits (sums wrap, relu and max meet the extremes)."""
    import torch
    info = torch.iinfo(dtype)
    x = torch.randint(info.min, info.max + 1, (n,), generator=g,
                      device=DEVICE, dtype=torch.int64).to(dtype)
    edge = [info.min, info.max, info.min + 1, info.max - 1, 0, -1, 1]
    x[:len(edge)] = torch.tensor(edge, dtype=dtype, device=DEVICE)
    return x


def _sass_opcodes(path) -> dict:
    """{kernel function: Counter of its SASS opcodes} of a built library
    (cuobjdump -sass); {} when cuobjdump cannot read it."""
    import collections
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    try:
        sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                              text=True, timeout=120).stdout
    except OSError as e:
        print(f"[dpx_dsm] SASS of {path}: not read ({e})", flush=True)
        return {}
    out = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        out[name] = collections.Counter(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]+\s+)?"
            r"([A-Z][A-Za-z0-9_.]*)", block))
    return out


def _is_dpx(op: str) -> bool:
    return op.startswith(("VIADDMNMX", "VIMNMX"))


def _kernel_label(mangled: str) -> str:
    """A short label of a mangled dpx.cu kernel name: its identifier and
    template arguments (sw_band_kernel<8>, ...<128,128,MaxPlusOp>)."""
    import re
    m = re.search(r"(sw_band_kernel|tropical_kernel|tma_pipelined_kernel|"
                  r"dpx_fused_kernel)I(.*)", mangled)
    if not m:
        return mangled[:60]
    args = re.findall(r"Li(\d+)E|Lb([01])E|(FmaOp|MaxPlusOp)", m.group(2))
    return f"{m.group(1)}<{','.join(''.join(x) for x in args)}>"


def _dpx_sass_opcodes() -> None:
    """The DPX opcodes in the SASS of each kernel of the built dpx
    library (each intrinsic one instruction); fails if a redesigned
    kernel (tropical's tma body, sw_band_kernel) has no VIADDMNMX, where
    the SASS can be read."""
    import collections
    from repro_torch.kernels import build
    path = build.library_path("dpx.cu")
    total = collections.Counter()
    sass = _sass_opcodes(path)
    for name, counts in sorted(sass.items()):
        dpx = {k: v for k, v in counts.items() if _is_dpx(k)}
        total.update(dpx)
        label = _kernel_label(name)
        print(f"[dpx_dsm]   SASS {label}: {sum(counts.values())} "
              f"instructions, DPX {dict(sorted(dpx.items()))}", flush=True)
        if (("sw_band" in label or "MaxPlusOp" in label)
                and not dpx.get("VIADDMNMX")):
            fail(f"{label}: no VIADDMNMX in its SASS ({dpx})")
    print(f"[dpx_dsm] DPX opcodes in the SASS of {os.path.relpath(path, ROOT)}"
          f": {sum(total.values())} ({dict(sorted(total.items()))})",
          flush=True)


DPX_RATE_OPS = ("viaddmax_s32", "viaddmax_s32_relu", "viaddmax_s16x2_relu")
DPX_RATE_ITERS = 8192
DPX_RATE_CHAINS = 8                   # instructions a thread an iteration


def probe_dpx_rate(rate: float) -> None:
    """A finding, not a gate: the DPX instructions' own rate with the
    operands in registers (csrc/dpx_rate_probe.cu), the intrinsic
    against the same function written as plain C, each variant's SASS
    (what the compiler made of the plain C) and whether the two agree."""
    import ctypes
    import re
    import torch
    from repro_torch.kernels import build
    try:
        path, _, _ = build.compile_source("dpx_rate_probe.cu")
    except RuntimeError as e:
        lines = [ln for ln in str(e).splitlines() if "rror" in ln]
        print(f"[dpx_dsm] DPX rate probe: nvcc refused it: "
              f"{lines[0].strip() if lines else e}", flush=True)
        return
    lib = ctypes.CDLL(str(path))
    fn = lib.dpx_rate_probe
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    blocks = torch.cuda.get_device_properties(0).multi_processor_count * 8
    threads = lib.dpx_rate_probe_threads()
    g = torch.Generator(device=DEVICE).manual_seed(14)
    seed = torch.randint(-(1 << 20), 1 << 20, (2 * DPX_RATE_CHAINS,),
                         generator=g, device=DEVICE, dtype=torch.int32)
    stream = torch.cuda.current_stream().cuda_stream
    instr = blocks * threads * DPX_RATE_CHAINS * DPX_RATE_ITERS
    sass = {}
    for name, counts in _sass_opcodes(path).items():
        m = re.search(r"dpx_rate_kernelILi(\d)ELb([01])E", name)
        if m:
            sass[(int(m.group(1)), int(m.group(2)))] = counts
    print(f"[dpx_dsm] DPX rate probe: {blocks} blocks x {threads} threads x "
          f"{DPX_RATE_CHAINS} chains x {DPX_RATE_ITERS} iterations = "
          f"{instr:.4g} instructions of each function; bound {rate:.4g}/s",
          flush=True)
    for op, name in enumerate(DPX_RATE_OPS):
        outs = []
        for fused in (1, 0):
            out = torch.empty(blocks * threads, dtype=torch.int32,
                              device=DEVICE)
            errs = []
            ms = _time_ms(lambda: errs.append(fn(
                op, fused, seed.data_ptr(), out.data_ptr(), blocks,
                DPX_RATE_ITERS, stream)), 3, warm=1)
            if any(errs):
                print(f"[dpx_dsm] DPX rate probe {name}: launch failed with "
                      f"CUDA error {max(errs)}", flush=True)
                return
            outs.append(out)
            counts = sass.get((op, fused), {})
            dpx = {k: v for k, v in counts.items() if _is_dpx(k)}
            top = ", ".join(f"{k} {v}" for k, v in counts.most_common(6))
            print(f"[dpx_dsm] DPX rate probe {name} "
                  f"{'intrinsic' if fused else 'plain C  '}: ms={ms:.4f} "
                  f"{instr / (ms * 1e-3):.4g} instructions/s = "
                  f"{instr / (ms * 1e-3) / rate:.3f} of the bound; SASS "
                  f"{sum(counts.values())} instructions, DPX {dpx}; most: "
                  f"{top}", flush=True)
        print(f"[dpx_dsm] DPX rate probe {name}: intrinsic and plain C "
              f"{'agree' if torch.equal(*outs) else 'DIFFER'}", flush=True)


def _rbc_case(res: dict, key: str, x, cs: int, hops: int, ilp: int) -> None:
    from repro_torch.kernels import dsm as dsk
    dname = str(x.dtype).replace("torch.", "")
    r = _exact(
        "rbc_ring_copy", f"{list(x.shape)} {dname} CS={cs} hops={hops} "
        f"ilp={ilp}",
        lambda: dsk.rbc_ring_copy(x, cs, hops=hops, ilp=ilp),
        lambda: dsk.rbc_ring_copy_plain(x, cs, hops=hops), 20,
        (2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3, "bytes"))
    print(f"[dpx_dsm]   rbc CS={cs} hops={hops} ilp={ilp}: "
          f"{x.numel() * 4 * hops / (r['ms'] * 1e-3) / 1e9:.1f} "
          f"GB/s over the SM-to-SM network", flush=True)
    res[("rbc_ring_copy", key)] = r


def _a2a_case(res: dict, key: str, x, cs: int) -> None:
    """The exchange against its plain version; the library call is the
    one permuting copy that computes it."""
    from repro_torch.kernels import dsm as dsk
    res[("all_to_all_exchange", key)] = _exact(
        "all_to_all_exchange", f"{list(x.shape)} float32 CS={cs}",
        lambda: dsk.all_to_all_exchange(x, cs),
        lambda: dsk.all_to_all_exchange_plain(x, cs), 20,
        (2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3, "bytes"),
        lib=lambda: x.view(cs, cs, -1).transpose(0, 1).contiguous())


def _hist_cases(res: dict, key: str, vals, nbins: int, sizes) -> None:
    """Both histograms of `vals` at each cluster size, against their
    plain versions, torch.bincount beside them; the private one only
    where a whole histogram fits a block's shared memory."""
    import torch
    from repro_torch.kernels import dsm as dsk
    from repro_torch.kernels import matmul as _mm
    bound = ((vals.numel() + nbins) * 4 / HBM_BYTES_PER_S * 1e3, "bytes")
    lib = lambda: torch.bincount(vals, minlength=nbins)
    for cs in sizes:
        for kernel, dsm, fn, plain_fn in (
                ("histogram_private", False, dsk.histogram_private,
                 dsk.histogram_private_plain),
                ("histogram_dsm", True, dsk.histogram_dsm,
                 dsk.histogram_dsm_plain)):
            smem = dsk.histogram_smem_bytes(dsm, nbins, cs)
            if smem > _mm.SMEM_LIMIT:
                print(f"[dpx_dsm] {kernel} nbins={nbins} CS={cs}: {smem} "
                      "bytes of shared memory a block, over the limit: not "
                      "run", flush=True)
                continue
            res[(kernel, f"{key}/{cs}")] = _exact(
                kernel, f"{vals.numel()} values nbins={nbins} CS={cs} "
                f"({smem // 1024} KiB a block)",
                lambda: fn(vals, nbins, cs),
                lambda: plain_fn(vals, nbins, cs), 20, bound, lib=lib)


def phase_dpx_dsm() -> tuple:
    """Every DPX and cluster kernel against its plain version on the
    card, exactly, at the benchmarks' inputs and at full size; the DPX
    opcodes and rate probe; then the dpx_functions, dpx_kernels and dsm
    benchmarks through the kernels.
    Returns (results keyed (kernel, case), launch counts of the
    benchmark run, and its launches by body of tropical_matmul and
    smith_waterman)."""
    import torch
    from repro_torch.core import bench
    from repro_torch.kernels import dpx_kernel as dk
    from repro_torch.kernels import dsm as dsk
    from repro_torch.benchmarks import run as _registers  # noqa: F401
    rate, mhz = _int_rate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"[dpx_dsm] int32 rate for the DPX bounds: {sms} SMs x "
          f"{INT32_LANES_PER_SM} lanes x {mhz:.0f} MHz = {rate:.4g} "
          f"instructions/s; bytes at {HBM_BYTES_PER_S:.3g} B/s", flush=True)
    g = torch.Generator(device=DEVICE).manual_seed(14)
    res = {}
    # DPX functions: one instruction per int32 element, per int16 pair
    for dtype, n in ((torch.int32, DPX_N), (torch.int16, DPX_N),
                     (torch.int16, DPX_N + 1), (torch.int32, 1 << 16),
                     (torch.int16, 1 << 16)):
        dname = str(dtype).replace("torch.", "")
        a, b, c = (_limit_ints(n, dtype, g) for _ in range(3))
        instr = n if dtype == torch.int32 else -(-n // 2)
        for name in dk.FUNCTIONS:
            res[("dpx_fused", f"{name}/{dname}/{n}")] = _exact(
                "dpx_fused", f"{name} {dname} n={n}",
                lambda: dk.dpx_fused(name, a, b, c),
                lambda: dk.dpx_fused_plain(name, a, b, c),
                20 if n > 1 << 16 else 50,
                _ops_bound(instr, 4 * n * a.element_size(), rate))
        del a, b, c
    # tropical (max,+) product: one viaddmax per (i, j, k), each call on
    # the body its rule names; at full size the staged body too, forced
    # by its rule with A 4 bytes off a 16-byte boundary
    for size, cases, lim in (
            (64, (("tma", (32, 32, 32)),), 50),
            (TROPICAL_FULL, (("tma", (32, 32, 32)),
                             ("staged", (32, 32, 32)),
                             ("staged", (64, 64, 32))), 1 << 20)):
        a = torch.randint(-lim, lim, (size, size), generator=g, device=DEVICE,
                          dtype=torch.int32)
        b = torch.randint(-lim, lim, (size, size), generator=g, device=DEVICE,
                          dtype=torch.int32)
        a_off = torch.empty(size * size + 1, dtype=torch.int32,
                            device=DEVICE)[1:].view(size, size)
        a_off.copy_(a)
        for want, (bm, bn, bk) in cases:
            x = a if want == "tma" else a_off
            name = _dpx_body(dk.tropical_matmul,
                             lambda: dk.tropical_matmul(x, b, bm=bm, bn=bn,
                                                        bk=bk))
            if name != want or name != dk.body(size, size, size,
                                               want == "tma"):
                fail(f"tropical_matmul {size}^3: body {name}, expected "
                     f"{want}")
            key = f"{size}/{name}" + (f"/{bm}x{bn}x{bk}" if name == "staged"
                                       else "")
            res[("tropical_matmul", key)] = _exact(
                "tropical_matmul", f"M=N=K={size} body={name}"
                + (f" bm={bm} bn={bn} bk={bk}" if name == "staged" else
                   " (128 x 128 tiles, 32-deep slices, 4 stages)"),
                lambda: dk.tropical_matmul(x, b, bm=bm, bn=bn, bk=bk),
                lambda: dk.tropical_matmul_plain(a, b),
                5 if size > 64 else 50,
                _ops_bound(size ** 3, 3 * size * size * 4, rate),
                extra=f"; {size ** 3 / 1e9:.3g} G cells")
        del a, b, a_off, x
    # Smith-Waterman: three int32 instructions per cell (an add and two
    # DPX instructions), each case on the body its plan names
    for B, la, lb in ((4, 64, 64), SW_BATCH, SW_LONG, SW_PAST_CAP):
        sa = torch.randint(0, 4, (B, la), generator=g, device=DEVICE,
                           dtype=torch.int32)
        sb = torch.randint(0, 4, (B, lb), generator=g, device=DEVICE,
                           dtype=torch.int32)
        cells = B * la * lb
        p = dk.smith_waterman_plan(la, lb)
        name = _dpx_body(dk.smith_waterman, lambda: dk.smith_waterman(sa, sb))
        if name != p.body:
            fail(f"smith_waterman {B}x{la}x{lb}: body {name}, plan {p}")
        res[("smith_waterman", f"{B}x{la}x{lb}")] = _exact(
            "smith_waterman", f"B={B} La={la} Lb={lb} body={name} S={p.S} "
            f"bands={p.bands} warps={p.warps}",
            lambda: dk.smith_waterman(sa, sb),
            lambda: dk.smith_waterman_plain(sa, sb), 5 if B > 4 else 20,
            _ops_bound(3 * cells, 4 * (B * (la + lb) + B), rate),
            extra=f"; {cells / 1e9:.3g} G cells")
        del sa, sb
    x = torch.randint(0, 4, (1, SW_IDENTICAL), generator=g, device=DEVICE,
                      dtype=torch.int32)
    y = x.clone()
    got = dk.smith_waterman(x, y)
    torch.cuda.synchronize()
    want = 2 * SW_IDENTICAL                  # match x the whole diagonal
    ms = _time_ms(lambda: dk.smith_waterman(x, y), 2, warm=0)
    p = dk.smith_waterman_plan(SW_IDENTICAL, SW_IDENTICAL)
    print(f"[dpx_dsm] smith_waterman B=1 La=Lb={SW_IDENTICAL} identical, "
          f"body={p.body} bands={p.bands} warps={p.warps}: "
          f"{int(got[0])} (closed form {want}) ms={ms:.4f}", flush=True)
    if int(got[0]) != want:
        fail(f"smith_waterman {SW_IDENTICAL}^2 identical: {int(got[0])}, "
             f"closed form {want}")
    del x, y
    # cluster kernels: bounded by device-memory bytes; first at the dsm
    # benchmark's own inputs (cluster size 4: a [4, 65536] ring, 1 MiB a
    # rank at CS 2/4/8, 4 * 32768 values in [0, 1024)), then at full size
    ring = torch.arange(4 * 65536, dtype=torch.float32,
                        device=DEVICE).reshape(4, 65536)
    for hops in (1, 3):
        for ilp in (1, 4):
            _rbc_case(res, f"bench/4/{hops}/{ilp}", ring, 4, hops, ilp)
    for cs in (2, 4, 8):
        ones = torch.ones((cs, 1 << 18), dtype=torch.float32, device=DEVICE)
        for ilp in (1, 4):
            _rbc_case(res, f"bench/ones/{cs}/{ilp}", ones, cs, 1, ilp)
    _a2a_case(res, "bench/4", ring, 4)
    del ring, ones
    # cluster sizes 1 (no DSM: a one-block ring adds copies of itself)
    # to 16 (non-portable), ILP 8, and an int32 ring whose sums wrap
    for cs in CLUSTER_SIZES:
        x = torch.randn((cs, RING_N // cs), generator=g, device=DEVICE)
        for hops in sorted({1, min(3, max(cs - 1, 1))}):
            for ilp in (1, 4, 8) if cs in (4, 16) else (1, 4):
                _rbc_case(res, f"{cs}/{hops}/{ilp}", x, cs, hops, ilp)
        _a2a_case(res, f"{cs}", x, cs)
        del x
        if cs in (1, 4, 16):
            xi = _limit_ints(RING_N, torch.int32, g).reshape(cs, -1)
            hops = max(cs - 1, 3 if cs == 1 else 0)
            _rbc_case(res, f"int32/{cs}/{hops}/8", xi, cs, hops, 8)
            del xi
        probe = torch.arange(cs, dtype=torch.int32, device=DEVICE)
        probe = probe.reshape(cs, 1)
        res[("ring_latency_probe", f"{cs}")] = _exact(
            "ring_latency_probe", f"CS={cs}",
            lambda: dsk.ring_latency_probe(probe),
            lambda: dsk.ring_latency_probe_plain(probe), 50,
            (8 * cs / HBM_BYTES_PER_S * 1e3, "bytes"),
            lib=lambda: torch.roll(probe, 1, 0))
    vals = torch.randint(0, 1024, (4 * 32768,), generator=g, device=DEVICE,
                         dtype=torch.int32)
    for nbins in (1024, 4096):
        _hist_cases(res, f"bench/{nbins}", vals, nbins, (4,))
    for nbins in HIST_BINS:
        vals = torch.randint(0, nbins, (HIST_N,), generator=g, device=DEVICE,
                             dtype=torch.int32)
        _hist_cases(res, f"{nbins}", vals, nbins, CLUSTER_SIZES)
    del vals
    _dpx_sass_opcodes()
    probe_dpx_rate(rate)
    # the three benchmarks through the kernels: the main path of this
    # phase, with the counts set to 0 just before and read just after
    torch.cuda.synchronize()
    dk.reset_launch_counts()
    dsk.reset_launch_counts()
    t0 = time.perf_counter()
    bench.run_all(["dpx_functions", "dpx_kernels", "dsm"], fail_fast=True,
                  device=torch.device(DEVICE))
    torch.cuda.synchronize()
    launches = {**dk.launch_counts(), **dsk.launch_counts()}
    bodies = {fn.__name__: dict(fn.launches_by_body)
              for fn in (dk.tropical_matmul, dk.smith_waterman)}
    print(f"[dpx_dsm] benchmarks ran in {time.perf_counter() - t0:.1f} s; "
          f"launch counts {launches}; by body {bodies}", flush=True)
    if min(launches.values()) <= 0:
        fail(f"a kernel of the DPX/DSM path was never launched: {launches}")
    return res, launches, bodies


# ----------------------------------------------------------------------
# 10. training: flash attention (B9) and full-width yi-6b steps
# ----------------------------------------------------------------------

# the cases of phase 10(a): name, dtype, B, Sq, Sk, H, KH, hd, causal,
# window, q_offset
FLASH_CASES = [
    ("kernels-1", "float32", 2, 128, 128, 8, 2, 32, True, 0, 0),
    ("kernels-2", "float32", 1, 128, 128, 4, 4, 64, True, 0, 0),
    ("kernels-3", "float32", 2, 256, 256, 8, 1, 32, False, 0, 0),
    ("kernels-4", "float32", 1, 64, 64, 6, 3, 16, True, 0, 0),
    ("kernels-bf16", "bfloat16", 1, 128, 128, 4, 2, 32, True, 0, 0),
    ("yi-6b", "bfloat16", 2, 4096, 4096, 32, 4, 128, True, 0, 0),
    ("llama-te-mini", "bfloat16", 2, 2048, 2048, 12, 12, 64, True, 0, 0),
    ("window", "bfloat16", 2, 2048, 2048, 32, 4, 128, True, 512, 0),
    ("ragged", "bfloat16", 2, 1000, 1000, 32, 4, 128, True, 0, 0),
    ("q_offset", "bfloat16", 2, 256, 1280, 32, 4, 128, True, 0, 1024),
    ("ragged-f32", "float32", 1, 333, 333, 8, 2, 64, True, 0, 0),
    ("no-valid-key", "float32", 1, 64, 96, 4, 2, 64, False, 8, 128),
    ("no-valid-key-bf16", "bfloat16", 1, 64, 96, 4, 2, 128, False, 8, 128),
    ("hd80-bf16", "bfloat16", 2, 2048, 2048, 16, 2, 80, True, 0, 0),
    ("hd80-f32", "float32", 1, 333, 333, 8, 2, 80, True, 64, 0),
    # multi-head (KH = H) at head_dim 128: te_transformer_layer's shape
    # at Table II's hidden 8192
    ("te-h8192", "bfloat16", 4, 512, 512, 64, 64, 128, True, 0, 0),
    # whisper-small (phase 14) on a batch of 8 30-second windows: the
    # bidirectional encoder over 1500 frames (1500 = 11 x 128 + 92: a
    # ragged last key tile) and cross-attention of the 448 decoder rows
    # against them
    ("whisper-enc", "bfloat16", 8, 1500, 1500, 12, 12, 64, False, 0, 0),
    ("whisper-cross", "bfloat16", 8, 448, 1500, 12, 12, 64, False, 0, 0),
    # phase 16's shards of yi-6b under fsdp_tp on a (2, 4) mesh: one row
    # a data position, 8 of the 32 heads over 1 of the 4 kv heads (G=8)
    ("yi-6b-fsdp-tp-shard", "bfloat16", 1, 4096, 4096, 8, 1, 128, True, 0,
     0),
    # phase 17's shards on the same mesh (one row a data position, a
    # quarter of the heads a model position): moonshot-v1-16b-a3b (4 of
    # 16 heads over 4 kv heads), zamba2-2.7b's shared block (8 of 32 at
    # hd 80: mma_sync), whisper-small's encoder, decoder and
    # cross-attention (3 of 12 at hd 64)
    ("moonshot-fsdp-tp-shard", "bfloat16", 1, 2048, 2048, 4, 4, 128, True,
     0, 0),
    ("zamba2-fsdp-tp-shard", "bfloat16", 1, 2048, 2048, 8, 8, 80, True, 0,
     0),
    ("whisper-enc-shard", "bfloat16", 1, 1500, 1500, 3, 3, 64, False, 0, 0),
    ("whisper-dec-shard", "bfloat16", 1, 448, 448, 3, 3, 64, True, 0, 0),
    ("whisper-cross-shard", "bfloat16", 1, 448, 1500, 3, 3, 64, False, 0,
     0),
]
# B9 against its plain version: float32 o within 1e-4 (the reference's
# kernel tests); bf16 o within one bf16 step of max |o| (2**-7 * max|o|);
# lse (float32 rows) within 1e-4 of max(1, max |lse|): a float32 score
# of magnitude x carries rounding of order 1e-7 * x, and the random
# full-width stack's scores reach the thousands
FLASH_F32_LIMIT = 1e-4
FLASH_BF16_STEP = 2.0 ** -7
# dq, dk, dv with the kernel forward against the plain forward on the
# same inputs, bf16: the backward reads the forward's bf16 output (one
# step apart in places) and ends in a bf16 rounding: 2**-5 of max |g|
FLASH_GRAD_REL_LIMIT = 2.0 ** -5
TRAIN_LAYERS = 8      # full-width yi-6b, depth cut to fit one 80 GB card
# kernel-name patterns of the profiled training step, by kind
TRAIN_KERNEL_GROUPS = {
    "B9 flash_fwd": ("flash_fwd",),
    "fp32 GEMM (flash backward, plain einsums)": ("sgemm", "f32f32"),
    "bf16 GEMM (projections, MLP, unembed)": ("nvjet", "bf16", "xmma"),
    "elementwise and reductions": ("elementwise", "reduce", "Reduce"),
}


def _attended_pairs(B, Sq, Sk, H, causal, window, q_offset) -> int:
    """(query head, key) pairs the mask lets through: the operations
    this run's inputs need (4*hd a pair)."""
    import numpy as np
    pos = q_offset + np.arange(Sq)
    hi = np.minimum(Sk - 1, pos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros(Sq, int)
    return int(B * H * np.maximum(hi - lo + 1, 0).sum())


def _flash_bound(dtype_name, B, Sq, Sk, H, KH, hd, causal, window,
                 q_offset, elt) -> tuple:
    """Least time: q, k, v read once, o and lse written once, over the
    HBM rate; 4*hd operations per attended pair over the peak of the
    dtype (bf16 tensor cores; float32 on the CUDA cores)."""
    nbytes = (2 * B * Sq * H * hd + 2 * B * Sk * KH * hd) * elt + \
        4 * B * H * Sq
    ops = 4 * hd * _attended_pairs(B, Sq, Sk, H, causal, window, q_offset)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _sdpa_yardstick(q, k, v, causal, window, q_offset):
    """One scaled_dot_product_attention call over the same inputs (a
    yardstick the port never calls): head-major views made outside the
    timing, is_causal for plain causal cells, a boolean mask otherwise."""
    import torch
    import torch.nn.functional as F
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    Sq, Sk = q.shape[1], k.shape[1]
    kw = {"enable_gqa": True}
    if causal and not window and not q_offset and Sq == Sk:
        kw["is_causal"] = True
    elif causal or window:
        pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        t = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= t <= pos
        if window:
            mask &= t > pos - window
        kw["attn_mask"] = mask
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, **kw)


def _lse_err(lse, plse) -> float:
    """|kernel - plain| of the lse rows over max(1, max |plain|)."""
    return ((lse - plse).abs().max()
            / plse.abs().max().clamp(min=1.0)).item()


def phase_flash() -> dict:
    """10(a): B9 against its plain version on every case.  Returns the
    results keyed by case name."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as kfa
    results = {}
    for i, (name, dname, B, Sq, Sk, H, KH, hd, causal, window,
            q_offset) in enumerate(FLASH_CASES):
        dtype = getattr(torch, dname)
        g = torch.Generator(device=DEVICE).manual_seed(100 + i)
        q = torch.randn((B, Sq, H, hd), generator=g, device=DEVICE).to(dtype)
        k = torch.randn((B, Sk, KH, hd), generator=g, device=DEVICE).to(dtype)
        v = torch.randn((B, Sk, KH, hd), generator=g, device=DEVICE).to(dtype)
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        kern = lambda: kfa.flash_attention_fwd(q, k, v, **kw)
        plain = lambda: kfa.flash_attention_fwd_plain(q, k, v, **kw)
        body = kfa.body(dtype, hd)
        code = build.load(kfa.SOURCE).flash_attention_body(
            kfa._DTYPES[dtype], hd)
        if kfa.BODIES[code] != body:
            fail(f"flash_attention {name}: the source's rule says "
                 f"{kfa.BODIES[code]}, its Python mirror {body}")
        before = kfa.body_launches()
        o, lse = kern()
        torch.cuda.synchronize()
        after = kfa.body_launches()
        ran = [x for x in after if after[x] != before[x]]
        if ran != [body]:
            fail(f"flash_attention {name}: the rule names {body}, the call "
                 f"launched {ran}")
        po, plse = plain()
        if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
            fail(f"flash_attention {name}: non-finite kernel output")
        err = (o.float() - po.float()).abs().max().item()
        lse_err = _lse_err(lse, plse)
        top = po.float().abs().max().item()
        limit = (FLASH_F32_LIMIT if dname == "float32"
                 else FLASH_BF16_STEP * top)
        big = B * Sq * H > 1 << 18
        ms = _time_ms(kern, 10 if big else 50)
        plain_ms = _time_ms(plain, 2 if big else 5, warm=1)
        lib_ms = _time_ms(_sdpa_yardstick(q, k, v, causal, window, q_offset),
                          10 if big else 50)
        bound_ms, bound_by = _flash_bound(dname, B, Sq, Sk, H, KH, hd, causal,
                                          window, q_offset, q.element_size())
        ok = err <= limit and lse_err <= FLASH_F32_LIMIT
        tflops = 4 * hd * _attended_pairs(B, Sq, Sk, H, causal, window,
                                          q_offset) / (ms * 1e-3) / 1e12
        print(f"[flash] {name} {dname} B={B} Sq={Sq} Sk={Sk} H={H} KH={KH} "
              f"hd={hd} causal={causal} window={window} q_offset={q_offset} "
              f"body={body}: "
              f"max_abs_err o={err:.3e} (limit {limit:.3e}, max|o| "
              f"{top:.3f}) lse={lse_err:.3e} (relative, limit "
              f"{FLASH_F32_LIMIT:.0e}) "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} sdpa_ms={lib_ms:.4f} "
              f"bound_ms={bound_ms:.5f} ({bound_by}) TFLOP/s={tflops:.1f} "
              f"{'ok' if ok else 'OVER LIMIT'}", flush=True)
        if not ok:
            fail(f"flash_attention {name}: o error {err} (limit {limit}), "
                 f"lse error {lse_err}")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms, "body": body}
        del q, k, v, o, lse, po, plse
    return results


class _PlainForward:
    """Within the block, models/attention.flash_attention runs its
    forward through the plain version (the backward is the same code
    either way)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as kfa
        self.orig = kfa.flash_attention_fwd
        kfa.flash_attention_fwd = kfa.flash_attention_fwd_plain
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import flash_attention as kfa
        kfa.flash_attention_fwd = self.orig


class _CheckedFlash:
    """Within the block every B9 launch (kernels.flash_attention.
    flash_attention_fwd) is also run through its plain version on its
    own inputs: `calls`, the worst o error over max |o| (`worst`) and
    lse error (`lse`), and the first call's inputs of each (Sq, Sk,
    causal) (`first`: q, k, v, keywords)."""

    def __enter__(self):
        from repro_torch.kernels import flash_attention as kfa
        self.kfa, self.orig = kfa, kfa.flash_attention_fwd
        self.calls, self.worst, self.lse, self.first = 0, 0.0, 0.0, {}

        def checked(q, k, v, **kw):
            import torch
            o, lse = self.orig(q, k, v, **kw)
            with torch.no_grad():
                po, plse = kfa.flash_attention_fwd_plain(q, k, v, **kw)
                self.calls += 1
                self.worst = max(self.worst, (
                    (o.float() - po.float()).abs().max()
                    / po.float().abs().max()).item())
                self.lse = max(self.lse, _lse_err(lse, plse))
            key = (q.shape[1], k.shape[1], kw.get("causal", True))
            if key not in self.first:
                self.first[key] = tuple(x.detach().clone()
                                        for x in (q, k, v)) + (kw,)
            return o, lse

        kfa.flash_attention_fwd = checked
        return self

    def __exit__(self, *exc):
        self.kfa.flash_attention_fwd = self.orig


def phase_flash_grads() -> None:
    """10(b): dq, dk, dv of the autograd function with the kernel
    forward against the same function with the plain forward, on the
    same inputs at the full-width training shape."""
    import torch
    from repro_torch.models import attention
    B, S, H, KH, hd = 2, 4096, 32, 4, 128
    g = torch.Generator(device=DEVICE).manual_seed(7)
    q, k, v, do = (torch.randn(shape, generator=g, device=DEVICE)
                   .to(torch.bfloat16)
                   for shape in ((B, S, H, hd), (B, S, KH, hd),
                                 (B, S, KH, hd), (B, S, H, hd)))
    leaves = [x.requires_grad_() for x in (q, k, v)]

    def grads():
        out = attention.flash_attention(*leaves, causal=True)
        return torch.autograd.grad(out, leaves, do)

    t0 = time.perf_counter()
    got = grads()
    with _PlainForward():
        want = grads()
    torch.cuda.synchronize()
    worst = 0.0
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        if not torch.isfinite(a.float()).all():
            fail(f"flash_attention backward: non-finite {name}")
        rel = ((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item()
        worst = max(worst, rel)
        print(f"[flash] grads B={B} S={S} H={H} KH={KH} hd={hd} bf16 causal:"
              f" {name} max |kernel - plain| / max |plain| = {rel:.3e} "
              f"(limit {FLASH_GRAD_REL_LIMIT:.3e})", flush=True)
    print(f"[flash] grads in {time.perf_counter() - t0:.1f} s", flush=True)
    if worst > FLASH_GRAD_REL_LIMIT:
        fail(f"flash_attention gradients with the kernel forward differ from "
             f"the plain forward's by {worst:.3e} of max |g|")


def _train_config(cfg, layers: int):
    import dataclasses
    return dataclasses.replace(cfg, num_layers=layers, remat="dots")


def phase_train_step(cfg, B: int = 2, S: int = 4096, extra=None,
                     flash_calls=None) -> None:
    """10(c): one full-width training step (8 layers, remat dots, fp32
    parameters and moments), every flash-attention call held against
    its plain version on the same inputs; the loss of the same batch
    through the plain forward printed beside it (random full-width
    stacks are chaotic: not gated).  Phases 12 and 13 run it on the
    families (`extra`: SyntheticLMData's extra inputs, a vlm's
    prefix_embeds; `flash_calls`: the step's flash forwards, forward
    and remat recompute, when not two a layer)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.models import api
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.trainer import make_train_step
    t0 = time.perf_counter()
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.float32)
    opt = AdamW(learning_rate=1e-3, warmup_steps=1, total_steps=100)
    state = opt.init(params)
    batch = {k: v.to(DEVICE) for k, v in next(
        SyntheticLMData(cfg.vocab_size, B, S,
                        extra=extra).batches(0)).items()}
    torch.cuda.synchronize()
    print(f"[train] {cfg.name} full width, {cfg.num_layers} layers: "
          f"{cfg.param_count() / 1e9:.2f} B float32 params + AdamW state "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    with torch.no_grad(), _PlainForward():
        plain_loss = api.loss_fn(cfg, params, batch).item()
    with _CheckedFlash() as chk:
        t0 = time.perf_counter()
        params, state, metrics = make_train_step(cfg, opt)(params, state,
                                                           batch)
        loss = metrics["loss"].item()
    print(f"[train] one step with every flash call checked "
          f"({time.perf_counter() - t0:.1f} s): {chk.calls} calls "
          f"(forward + remat recompute), max |kernel - plain| / max |o| = "
          f"{chk.worst:.3e} (limit {FLASH_BF16_STEP:.3e}), lse "
          f"{chk.lse:.3e} (relative, limit {FLASH_F32_LIMIT:.0e}); loss "
          f"{loss:.5f} "
          f"(plain forward: {plain_loss:.5f}), grad_norm "
          f"{metrics['grad_norm'].item():.4f}", flush=True)
    if not (torch.isfinite(metrics["loss"]) and
            torch.isfinite(metrics["grad_norm"])):
        fail("full-width training step gave a non-finite loss or gradient")
    want = 2 * cfg.num_layers if flash_calls is None else flash_calls
    if chk.calls != want:
        fail(f"the step ran {chk.calls} flash forwards, not {want} "
             f"(forward + recompute of each attention)")
    if chk.worst > FLASH_BF16_STEP or chk.lse > FLASH_F32_LIMIT:
        fail(f"a flash call of the training step differs from its plain "
             f"version: o {chk.worst:.3e} of max |o|, lse {chk.lse:.3e}")


def phase_trainer(cfg, steps: int = 4, B: int = 2, S: int = 4096,
                  extra=None, descent: str = "steps", flash_calls=None,
                  flash_body: str = "wgmma") -> tuple:
    """10(d): Trainer.run on the full-width 8-layer config (phase 12:
    the families' configs, `extra` as in phase_train_step), fresh
    batches every step; the main path of this phase, with B9's count
    set to 0 just before and read just after.  `descent` names the gate
    on the losses: "steps" (phase 10: the last step's loss below the
    first's), "batches" (the mean loss of the run's own batches falls
    from before the steps to after them: four steps move a fresh
    batch's loss less than the batches differ) or "" (that mean printed,
    not gated: on a random 24-layer internvl2-1b stack, chaotic in the
    reference as in the port, four steps move it by about a thousandth;
    PERF.md §6).  `flash_calls` (B9 launches a step, default two a
    layer) and `flash_body` (the body they run) as phase 13's families
    need.  Then one more step under torch.profiler: the device time by
    kernel.  Returns the launch counts, by body too."""
    import tempfile
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer
    with tempfile.TemporaryDirectory() as td:
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=100, ckpt_every=10 ** 6, ckpt_dir=td)
        data = SyntheticLMData(cfg.vocab_size, B, S, extra=extra)
        tr = Trainer(cfg, tcfg, data=data, device=DEVICE)
        tr.init()
        seen = []
        if descent != "steps":
            it = data.batches(0)
            seen = [{k: v.to(DEVICE) for k, v in next(it).items()}
                    for _ in range(steps)]

        def seen_loss():
            with torch.no_grad():
                return sum(api.loss_fn(cfg, tr.params, b).item()
                           for b in seen) / max(len(seen), 1)

        before = seen_loss()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kfa.reset_launch_counts()
        hist = list(tr.run(steps))
        torch.cuda.synchronize()
        launches = kfa.launch_counts()
        bodies = kfa.body_launches()
        peak = torch.cuda.max_memory_allocated()
        after = seen_loss()
        t0 = time.perf_counter()
        with _device_profile() as prof:
            tr.run(1)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        del tr
    losses = [m.loss for m in hist]
    for m in hist:
        print(f"[train] Trainer.run step {m.step}: loss {m.loss:.5f} "
              f"grad_norm {m.grad_norm:.4f} step_ms "
              f"{m.step_time_s * 1e3:.1f} tokens/s "
              f"{B * S / m.step_time_s:.1f}", flush=True)
    steady = hist[1:] or hist
    step_s = sum(m.step_time_s for m in steady) / len(steady)
    print(f"[train] {cfg.name} full width {cfg.num_layers} layers, B={B} "
          f"S={S}, "
          f"remat {cfg.remat}: {steps} steps, steady step_ms "
          f"{step_s * 1e3:.1f}, tokens/s {B * S / step_s:.1f}, peak memory "
          f"{peak / 1e9:.2f} GB, flash_attention launches "
          f"{launches['flash_attention']} ({launches['flash_attention'] / steps:g}"
          f" per step), by body {bodies}", flush=True)
    by_name = _device_ms_by_kernel(prof, 1)
    dev, groups = _train_profile_split(prof)
    split = "; ".join(f"{g} {ms:.1f}" for g, ms in groups.items())
    top = "; ".join(f"{n[:60]} {ms:.2f}" for n, ms in
                    by_name.most_common(8))
    print(f"[profile] one Trainer.run step under the profiler: wall "
          f"{wall:.1f} ms; "
          + (f"device {dev:.1f} ms, {dev / (step_s * 1e3):.0%} of an "
             f"unprofiled step ({step_s * 1e3:.1f} ms); device ms by kind: "
             f"{split}; top kernels (ms): {top}" if dev
             else "device time not measured (the profiler saw no kernel)"),
          flush=True)
    if not all(math.isfinite(x) for x in losses):
        fail(f"Trainer.run gave non-finite losses {losses}")
    if seen:
        print(f"[train] {cfg.name}: mean loss of the run's {steps} batches "
              f"before the steps {before:.5f}, after {after:.5f}"
              + ("" if descent else " (printed, not gated)"), flush=True)
    if descent == "steps" and not losses[-1] < losses[0]:
        fail(f"Trainer.run losses did not fall: {losses}")
    if descent == "batches" and not after < before:
        fail(f"Trainer.run did not lower the loss of its own batches: "
             f"{before} before the steps, {after} after")
    per_step = 2 * cfg.num_layers if flash_calls is None else flash_calls
    if launches["flash_attention"] != per_step * steps:
        fail(f"flash_attention launched {launches} times in {steps} steps, "
             f"not {per_step} a step")
    if bodies[flash_body] != launches["flash_attention"]:
        fail(f"the training step ran B9 off its {flash_body} body: {bodies}")
    return launches, bodies


def phase_restart() -> None:
    """10(e): reduced yi-6b (remat dots) on the card: a run that fails
    after its fifth step and restarts from its step-4 checkpoint (one
    every 2 steps) gives the losses of an uninterrupted run, bit for
    bit (step 5 runs twice)."""
    import dataclasses
    import tempfile
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.runtime.trainer import Trainer
    cfg = dataclasses.replace(reduced_config("yi-6b"), num_kv_heads=2,
                              remat="dots")
    runs = []
    for fail_at in (5, None):
        with tempfile.TemporaryDirectory() as td:
            tcfg = TrainConfig(total_steps=50, warmup_steps=2, ckpt_every=2,
                               ckpt_dir=td, learning_rate=1e-3)
            tr = Trainer(cfg, tcfg, data=SyntheticLMData(cfg.vocab_size, 4,
                                                         64, seed=0),
                         fail_at_step=fail_at, device=DEVICE)
            tr.init()
            hist = tr.run(8)
            runs.append(({m.step: m.loss for m in hist}, tr.restarts))
    (a, restarts), (b, _) = runs
    print(f"[train] reduced yi-6b on the card, failure after step 5 "
          f"({restarts} restart) vs uninterrupted: losses "
          f"{[a[s] for s in sorted(a)]} vs {[b[s] for s in sorted(b)]}",
          flush=True)
    if restarts != 1 or sorted(a) != list(range(1, 9)):
        fail(f"the failing run did not restart once: {restarts}, {sorted(a)}")
    if any(a[s] != b[s] for s in b):
        fail("restart is not bit-exact on the card: "
             f"{[(s, a[s], b[s]) for s in b if a[s] != b[s]]}")


def phase_training() -> tuple:
    """Phase 10, all of it.  Returns (B9 results by case, launches,
    launches by body)."""
    import torch
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    flash = phase_flash()
    phase_flash_grads()
    cfg = _train_config(get_config("yi-6b"), TRAIN_LAYERS)
    phase_train_step(cfg)
    torch.cuda.empty_cache()
    launches, bodies = phase_trainer(cfg)
    torch.cuda.empty_cache()
    phase_restart()
    print(f"[train] phase 10 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return flash, launches, bodies


# ----------------------------------------------------------------------
# 11. memory hierarchy and Transformer Engine (Tables II, IV, V; Figs. 3-5)
# ----------------------------------------------------------------------

# the classic pointer-chase sweep, past L1 (.cg), 4 KB to 1 GB by doubling
MEM_SWEEP = tuple(4096 << i for i in range(19))
MEM_SWEEP_ITERS = 4096
# a Table IV row past L1 and the sweep's point at its size chase chains
# of one size through the same level: within 10% of each other
PLATEAU_TOLERANCE = 0.10
# shared memory's 32 banks of 4 bytes a clock, an SM
SMEM_BYTES_PER_CLK = 128
# te_linear card against CPU: 33 x 2 = 66 tokens (wgrad contracts over
# them: not a multiple of 16), 256 -> 512
TE_CHECK = (33, 2, 256, 512)
# y and dx (bf16) within one bf16 step of each value, y, dx and dw within
# 2**-8 of their largest |value|: the card sums the exact fp8 products on
# the tensor cores, which keep about 14 bits between float32 promotions,
# the CPU in float32 in another order
TE_BF16_STEP = 2.0 ** -7
TE_SUM_REL = 2.0 ** -8
# te_transformer_layer on the card against the port on the CPU at this
# Table II hidden size
TE_LAYER_CPU_HIDDEN = 1024
# te_linear calls a profiler pass records (after one warm-up step)
TE_PROFILE_CALLS = 3
# where a te_linear call's device time goes, by kernel name (the first
# group whose pattern the name holds; the rest is "other")
TE_KERNEL_GROUPS = {
    "product (cuBLAS fp8)": ("gemm", "xmma", "nvjet", "cutlass"),
    "amax (abs, reduce)": ("AbsFunctor", "reduce_kernel"),
    "state update (history cat)": ("CatArrayBatchedCopy",),
    "layout (zero fill, strided copies)": ("FillFunctor",
                                           "at::native::elementwise_kernel<"),
    "quantize (float casts, divide, clamp, fp8 cast)": (
        "vectorized_elementwise_kernel", "unrolled_elementwise_kernel"),
}


def _sweep_chain(size: int, g):
    """A random one-cycle chain of size // 8 int64 entries made on the
    card (the sweep's; Table IV's rows use the reference's chain)."""
    import torch
    n = size // 8
    perm = torch.randperm(n, generator=g, device=DEVICE)
    chain = torch.empty_like(perm)
    chain[perm] = perm.roll(1)
    return chain


def _chase_checked(what: str, chain, load: str, iters: int, warm: int):
    """One chase on the card, its last index held to the host walk's.
    Returns (cycles a hop, ns a hop, host walk ms)."""
    from repro_torch.kernels import memory as mk
    last, cycles, ns = mk.pchase(chain, load, iters=iters,
                                 warm=warm).tolist()
    t0 = time.perf_counter()
    want = int(mk.pchase_plain(chain.cpu(), warm, iters)[0])
    plain_ms = (time.perf_counter() - t0) * 1e3
    if last != want:
        fail(f"pchase {what}: last index {last}, the host walk's {want}")
    return cycles / iters, ns / iters, plain_ms


def phase_memory() -> tuple:
    """11(a), before the benchmarks: the pointer-chase sweep (every
    size's last index held to the host walk's), and the kernel-line
    numbers the memory benchmarks do not give: a global-sized chase's
    call time against its host walk, the stream's plain version and
    torch.add yardstick, the on-chip read's plain version, and each
    kernel's bound.  The benchmarks time the kernels and hold each to
    its plain version.  Returns (cycles a hop by sweep size, results
    keyed (kernel, case))."""
    import torch
    from repro_torch.benchmarks import memory as mb
    from repro_torch.kernels import memory as mk
    t0 = time.perf_counter()
    _, mhz = _int_rate()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    g = torch.Generator(device=DEVICE).manual_seed(24)
    global_size = next(s for n, _, s in mb.LEVELS if n == "global")
    sweep, res = {}, {}
    for size in MEM_SWEEP:
        chain = _sweep_chain(size, g)
        iters = MEM_SWEEP_ITERS
        cyc, ns, _ = _chase_checked(f".cg {size} B", chain, "cg", iters,
                                    mb.warm_hops(chain.numel(), iters))
        sweep[size] = cyc
        print(f"[memory] sweep .cg {size:>10} B: {cyc:7.1f} cycles "
              f"{ns:7.1f} ns a hop (last index = host walk)", flush=True)
        if size == global_size:
            # the global row's work: its hops on a chain of its size
            iters = mb.LATENCY_ITERS
            warm = mb.warm_hops(chain.numel(), iters)
            _, _, plain_ms = _chase_checked("global-sized", chain, "cg",
                                            iters, warm)
            ms = _time_ms(lambda: mk.pchase(chain, "cg", iters=iters,
                                            warm=warm), 2, warm=0)
            res[("pchase", "global")] = {
                "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": 8 * (warm + iters) / HBM_BYTES_PER_S * 1e3,
                "bound_by": "bytes", "library_ms": None}
        del chain
    if ("pchase", "global") not in res:
        fail(f"the sweep has no point at the global row's {global_size} B")
    for name, size, passes in mb.STREAMS:
        x = torch.arange(size // 4, dtype=torch.float32, device=DEVICE)
        one = torch.ones((), device=DEVICE)
        # the plain version and the library call make one pass a call:
        # `passes` calls do the kernel's work
        res[("stream", name)] = {
            "max_abs_err": 0.0,
            "plain_ms": _time_ms(lambda: mk.stream_plain(x), 5) * passes,
            "library_ms": _time_ms(lambda: torch.add(one, x, alpha=2.0),
                                   5) * passes,
            "bound_ms": 2 * size * passes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"}
        del x
    src = torch.arange(mk.BW_WORDS, dtype=torch.int32, device=DEVICE)
    nbytes = sms * mb.ONCHIP_REPS * 4 * mk.BW_WORDS
    for name, _ in mb.ONCHIP:
        t1 = time.perf_counter()
        mk.onchip_bw_plain(src, mb.ONCHIP_REPS, sms)
        res[("onchip_bw", name)] = {
            "max_abs_err": 0.0,
            "plain_ms": (time.perf_counter() - t1) * 1e3,
            "bound_ms": nbytes / (SMEM_BYTES_PER_CLK * sms * mhz * 1e6) * 1e3,
            "bound_by": "bytes", "library_ms": None}
    print(f"[memory] 11(a) sweep and plain versions in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return sweep, res


def report_memory(rows: dict, sweep: dict, res: dict) -> None:
    """11(a), after the benchmarks: Table IV and V from their rows, the
    paper's H800 beside them; each row past L1 on the sweep's plateau at
    its size; the kernel line's ms from the rows."""
    import torch
    from repro_torch.benchmarks import device_label
    from repro_torch.benchmarks import memory as mb
    label = device_label(DEVICE)
    lat = {t.name: t for t in rows["memory_latency"]}
    h800 = dict(zip(("L1", "shared", "L2", "global"),
                    dict(mb.PAPER_LATENCY)["H800"]))
    for name, load, size in mb.LEVELS:
        t = lat[f"measured({label})/{name}"]
        cyc, ns = t.derived, t.us_per_call * 1e3
        on = ""
        if load == "cg":
            off = abs(cyc / sweep[size] - 1)
            on = (f"; sweep at {size} B {sweep[size]:.1f} cycles "
                  f"({off:.1%} off)")
            if off > PLATEAU_TOLERANCE:
                fail(f"pchase {name}: {cyc:.1f} cycles a hop, the sweep "
                     f"{sweep[size]:.1f} at the same size")
        print(f"[memory] Table IV {name} ({load}, {size} B, "
              f"{mb.LATENCY_ITERS} hops): {cyc:.1f} cycles {ns:.1f} ns a "
              f"hop, last index = host walk (paper H800 {h800[name]} "
              f"cycles){on}", flush=True)
    r = res[("pchase", "global")]
    print(f"[memory] pchase global-sized call: ms={r['ms']:.4f} plain_ms="
          f"{r['plain_ms']:.4f} bound_ms={r['bound_ms']:.5f} (bytes; a "
          f"dependent chain measures latency)", flush=True)
    thr = {t.name: t for t in rows["memory_throughput"]}
    for name, size, passes in mb.STREAMS:
        t = thr[f"measured({label})/{name}"]
        r = res[("stream", name)]
        r["ms"] = t.us_per_call / 1e3
        nbytes = 2 * size * passes
        print(f"[memory] Table V stream {name} ({size} B x {passes} "
              f"passes): bitwise x * 2 + 1; ms={r['ms']:.4f} "
              f"({t.derived:.1f} GB/s) plain_ms={r['plain_ms']:.4f} "
              f"library_ms={r['library_ms']:.4f} (torch.add, {passes} "
              f"calls: {nbytes / r['library_ms'] / 1e6:.1f} GB/s) "
              f"bound_ms={r['bound_ms']:.5f} (bytes over the device-memory "
              f"rate; L2-resident passes can beat it) "
              f"{r['ms'] / r['bound_ms']:.2f}x bound", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for name, _ in mb.ONCHIP:
        t = thr[f"measured({label})/{name}_bytes_per_clk_per_sm"]
        r = res[("onchip_bw", name)]
        r["ms"] = t.us_per_call / 1e3
        print(f"[memory] Table V {name}: {sms} blocks x {mb.ONCHIP_REPS} x "
              f"16 KB, checksums equal; {t.derived:.1f} bytes/clk/SM; "
              f"ms={r['ms']:.4f} plain_ms={r['plain_ms']:.4f} "
              f"bound_ms={r['bound_ms']:.5f} (bytes at {SMEM_BYTES_PER_CLK} "
              f"B/clk/SM) {r['ms'] / r['bound_ms']:.2f}x bound", flush=True)
    ratio = thr[f"measured({label})/l2_vs_global_ratio"].derived
    print(f"[memory] Table V L2 / global {ratio:.3f} (paper: RTX4090 4.67, "
          f"A100 2.01, H800 4.23); paper H800 global "
          f"{dict(mb.PAPER_GLOBAL_GBPS)['H800']} GB/s", flush=True)


def _te_err(name: str, got, want, step: float) -> float:
    """|card - CPU| against one `step` of each value plus TE_SUM_REL of
    the largest |value|; fails past it.  Returns the error over the
    largest |value|."""
    a, b = want.float(), got.detach().float().cpu()
    top = a.abs().max().item()
    err = (a - b).abs()
    over = (err > step * a.abs() + TE_SUM_REL * top).sum().item()
    rel = err.max().item() / top
    print(f"[te] te_linear {name}: max |card - CPU| {err.max().item():.3e} "
          f"= {rel:.3e} of max |{name}| {top:.3f} (limit {step:g} of each "
          f"value + {TE_SUM_REL:g} of the max); {over} over", flush=True)
    if over:
        fail(f"te_linear {name}: {over} values past the limit")
    return rel


def _bits(t):
    """The bytes of a tensor, on the host."""
    import torch
    return t.detach().cpu().contiguous().reshape(-1).view(torch.uint8)


def phase_te_linear_check() -> None:
    """11(b): te_linear and its backward on the card against the port on
    the CPU on the same inputs, parameters, state and cotangent, at a
    token count that is not a multiple of 16."""
    import numpy as np
    import torch
    from repro_torch.te import fp8
    from repro_torch.te.fp8 import E4M3, E5M2, DelayedScalingRecipe
    from repro_torch.te import linear
    B, S, K, N = TE_CHECK
    recipe = DelayedScalingRecipe()
    rng = np.random.default_rng(24)
    w = torch.from_numpy((rng.standard_normal((K, N)) * K ** -0.5)
                         .astype(np.float32))
    xs = [torch.from_numpy(rng.standard_normal((B, S, K)) * s).to(
        torch.bfloat16) for s in (1.0, 3.0)]
    g = torch.from_numpy(rng.standard_normal((B, S, N)) * 2.0).to(
        torch.bfloat16)
    outs = {}
    for dev in ("cpu", DEVICE):
        st = linear.init_state(recipe, dev)
        p = {"w": w.to(dev)}
        _, st = linear.te_linear(p, st, xs[0].to(dev), recipe)   # warm
        x = xs[1].to(dev).detach().clone().requires_grad_()
        wg = p["w"].detach().clone().requires_grad_()
        y, new = linear.te_linear({"w": wg}, st, x, recipe)
        y.backward(g.to(dev))
        sg = fp8.compute_scale(fp8.amax(g.to(dev)), E5M2)
        outs[dev] = {
            "xq": fp8.quantize(x.detach(), st["x"]["scale"], E4M3),
            "wq": fp8.quantize(wg.detach(), st["w"]["scale"], E4M3),
            "gq": fp8.quantize(g.to(dev), sg, E5M2), "sg": sg,
            "state": new, "y": y.detach(), "dx": x.grad, "dw": wg.grad}
    cpu, card = outs["cpu"], outs[DEVICE]
    for k in ("xq", "wq", "gq", "sg"):
        if not torch.equal(_bits(card[k]), _bits(cpu[k])):
            fail(f"te_linear: the card's {k} differs from the CPU's")
    for t in ("x", "w"):
        for f in ("history", "scale"):
            if not torch.equal(_bits(card["state"][t][f]),
                               _bits(cpu["state"][t][f])):
                fail(f"te_linear: new state {t}/{f} differs card vs CPU")
    print(f"[te] te_linear {B}x{S} tokens, {K} -> {N}: e4m3 codes of x and "
          f"w, e5m2 codes and scale of the cotangent, and the new states "
          f"bitwise equal card vs CPU", flush=True)
    _te_err("y", card["y"], cpu["y"], TE_BF16_STEP)
    _te_err("dx", card["dx"], cpu["dx"], TE_BF16_STEP)
    _te_err("dw", card["dw"], cpu["dw"], 0.0)


class _KeepAttentionInputs:
    """Within the block, models/attention.flash_attention keeps the q, k,
    v and options of its last call in `args`, and runs as before."""

    def __enter__(self):
        from repro_torch.models import attention
        self.orig = orig = attention.flash_attention

        def keep(q, k, v, **kw):
            self.args = (q.detach(), k.detach(), v.detach(), kw)
            return orig(q, k, v, **kw)

        attention.flash_attention = keep
        return self

    def __exit__(self, *exc):
        from repro_torch.models import attention
        attention.flash_attention = self.orig


def _te_flash_check(hidden: int, args) -> None:
    """B9 on the te layer's own q, k, v against its plain version, at
    FLASH_BF16_STEP of max |o| and FLASH_F32_LIMIT of the lse."""
    from repro_torch.kernels import flash_attention as kfa
    q, k, v, kw = args
    o, lse = kfa.flash_attention_fwd(q, k, v, **kw)
    po, plse = kfa.flash_attention_fwd_plain(q, k, v, **kw)
    err = (o.float() - po.float()).abs().max().item()
    top = po.float().abs().max().item()
    lse_err = _lse_err(lse, plse)
    ok = err <= FLASH_BF16_STEP * top and lse_err <= FLASH_F32_LIMIT
    print(f"[te] h{hidden} B9 on the layer's q {tuple(q.shape)}, k "
          f"{tuple(k.shape)} {q.dtype} {kw}: max_abs_err o={err:.3e} "
          f"(limit {FLASH_BF16_STEP * top:.3e}, max|o| {top:.3f}) lse="
          f"{lse_err:.3e} (relative, limit {FLASH_F32_LIMIT:.0e}) "
          f"{'ok' if ok else 'OVER LIMIT'}", flush=True)
    if not ok:
        fail(f"te_transformer_layer h{hidden}: B9 o error {err}, lse error "
             f"{lse_err} against its plain version")


def _histories(tree, path=""):
    """(path, history) of every fp8 state in a state tree."""
    if "history" in tree:
        return [(path, tree["history"])]
    return [x for k in tree for x in _histories(tree[k], f"{path}/{k}")]


def _te_layer_vs_cpu(cfg, params, x, y, new) -> None:
    """te_transformer_layer's second call from a fresh state, card (y,
    new) against the port on the CPU on the same weights and input: the
    weight histories bitwise; the output nearer the CPU's than the CPU's
    fp8 output is to the bf16 layer_fwd on the same weights (the CPU
    tests' fp8 bar: e4m3 turns a one-step bf16 difference into a
    one-step e4m3 difference)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.te.fp8 import DelayedScalingRecipe
    from repro_torch.te.layer import (te_transformer_layer,
                                      transformer_layer_state)
    recipe = DelayedScalingRecipe()
    t0 = time.perf_counter()
    p = _tree_to(params, "cpu")
    xc = x.cpu()
    st = transformer_layer_state(cfg, recipe, "cpu")
    _, st = te_transformer_layer(cfg, p, st, xc, recipe)
    want, st = te_transformer_layer(cfg, p, st, xc, recipe)
    d, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    lp = {"ln1": p["ln1"], "ln2": p["mlp"]["ln"],
          "attn": {"wq": p["wq"]["w"].reshape(d, H, hd),
                   "wk": p["wk"]["w"].reshape(d, KH, hd),
                   "wv": p["wv"]["w"].reshape(d, KH, hd),
                   "wo": p["wo"]["w"].reshape(H, hd, d)},
          "mlp": {"w_up": p["mlp"]["up"]["w"],
                  "w_gate": p["mlp"]["gate"]["w"],
                  "w_down": p["mlp"]["down"]["w"]}}
    B, S = xc.shape[:2]
    bf16, _ = transformer.layer_fwd(cfg, lp, xc,
                                    torch.arange(S).expand(B, S))
    diff = (y.float().cpu() - want.float()).abs().max().item()
    quant = (want.float() - bf16.float()).abs().max().item()
    weights, act = 0, 0.0
    for (path, a), (_, b) in zip(_histories(st), _histories(new)):
        if path.endswith("/w"):
            weights += 1
            if not torch.equal(_bits(a), _bits(b)):
                fail(f"te_transformer_layer: weight history {path} differs "
                     f"card vs CPU")
        else:
            top = a.abs().max().item()
            act = max(act, (a - b.cpu()).abs().max().item() / top)
    print(f"[te] te_transformer_layer h{cfg.d_model} B={B} S={S} card vs "
          f"CPU (second call from a fresh state): max |card - CPU| "
          f"{diff:.4f}, max |CPU fp8 - CPU bf16 layer_fwd| {quant:.4f} "
          f"(ratio {diff / quant:.3f}, limit 1); {weights} weight histories "
          f"bitwise; activation histories within {act:.3e} (relative); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not diff < quant:
        fail(f"te_transformer_layer: card vs CPU {diff}, not under the fp8 "
             f"bar {quant}")


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    return tree.to(device)


def phase_te_layer() -> None:
    """11(c): te_transformer_layer at Table II's five hidden sizes, B=4,
    S=512, from a fresh state: B9 on the layer's own q, k, v against its
    plain version; the second call finite, histories rolled, B9 launched
    once on its wgmma body, no host synchronization; at
    TE_LAYER_CPU_HIDDEN the card against the port on the CPU."""
    import torch
    from repro_torch.benchmarks import te_layer as bt
    from repro_torch.configs.llama_te import te_layer_config
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.te.fp8 import DelayedScalingRecipe
    from repro_torch.te.layer import (te_transformer_layer,
                                      transformer_layer_specs,
                                      transformer_layer_state)
    recipe = DelayedScalingRecipe()
    B, S = bt.CARD_SHAPE
    g = torch.Generator(device=DEVICE).manual_seed(25)
    for hidden in bt.CARD_HIDDEN:
        cfg = te_layer_config(hidden)
        params = bt._params(transformer_layer_specs(cfg), 0, DEVICE)
        state = transformer_layer_state(cfg, recipe, DEVICE)
        x = torch.randn((B, S, hidden), generator=g,
                        device=DEVICE).to(torch.bfloat16)
        with _KeepAttentionInputs() as kept:
            _, state = te_transformer_layer(cfg, params, state, x, recipe)
        _te_flash_check(hidden, kept.args)
        del kept
        torch.cuda.synchronize()
        kfa.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, new = te_transformer_layer(cfg, params, state, x, recipe)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        launches, bodies = kfa.launch_counts(), kfa.body_launches()
        hist = new["wq"]["x"]["history"]
        if not torch.isfinite(y.float()).all():
            fail(f"te_transformer_layer h{hidden}: non-finite output")
        if not (hist[:2] > 0).all() or hist[2:].any():
            fail(f"te_transformer_layer h{hidden}: history {hist.tolist()} "
                 "did not roll by one a call")
        if launches["flash_attention"] != 1 or bodies["wgmma"] != 1:
            fail(f"te_transformer_layer h{hidden}: B9 launches {launches}, "
                 f"by body {bodies}; expected one on wgmma")
        print(f"[te] te_transformer_layer h{hidden} (ffn {cfg.d_ff}, "
              f"{cfg.num_heads} heads of {cfg.head_dim}), B={B} S={S}: "
              f"finite, histories rolled, B9 once on wgmma, no host sync",
              flush=True)
        if hidden == TE_LAYER_CPU_HIDDEN:
            _te_layer_vs_cpu(cfg, params, x, y, new)
        del params, state, new, y, x
        torch.cuda.empty_cache()


def report_te(rows: dict) -> None:
    """11(b) and (c), after the benchmarks: Fig. 4 (bf16 and fp8 GFLOP/s
    a size, back to back and as a graph replay; the crossover and the
    largest ratio; the quantize fraction) and Fig. 5 (fp8 / bf16 a
    hidden size) from the te_linear and te_layer rows."""
    from repro_torch.benchmarks import device_label
    from repro_torch.benchmarks import te_layer as bt
    from repro_torch.benchmarks import te_linear as bl
    label = device_label(DEVICE)
    lin = {t.name: t.derived for t in rows["te_linear"]}
    rates = {}
    for n in bl.CARD_SIZES:
        r = {f"{t}{s}": lin[f"measured({label})/{t}/N{n}{s}"]
             for t in ("bf16", "fp8") for s in ("", "/graph")}
        rates[n] = r["fp8"] / r["bf16"]
        print(f"[te] Fig. 4 N={n}: bf16 {r['bf16']:.1f} GFLOP/s (graph "
              f"{r['bf16/graph']:.1f}), fp8 {r['fp8']:.1f} (graph "
              f"{r['fp8/graph']:.1f}); fp8 / bf16 {rates[n]:.3f} (graph "
              f"{r['fp8/graph'] / r['bf16/graph']:.3f})", flush=True)
    wins = [n for n in bl.CARD_SIZES if rates[n] > 1]
    best = max(bl.CARD_SIZES, key=rates.get)
    print(f"[te] Fig. 4: fp8 first beats bf16 at N={wins[0] if wins else None}"
          f"; largest fp8 / bf16 {rates[best]:.3f} at N={best}; quantize "
          f"fraction at N=512 "
          f"{lin[f'measured({label})/quantize_fraction_N512']:.3f}",
          flush=True)
    lay = {t.name: t.us_per_call for t in rows["te_layer"]}
    B, S = bt.CARD_SHAPE
    for hidden in bt.CARD_HIDDEN:
        f8, b16 = (lay[f"measured({label})/{t}/h{hidden}"] / 1e3
                   for t in ("fp8", "bf16"))
        print(f"[te] Fig. 5 h{hidden}, B={B} S={S}: fp8 {f8:.4f} ms, bf16 "
              f"layer_fwd {b16:.4f} ms, fp8 / bf16 {f8 / b16:.3f}",
              flush=True)
    print("[te] paper (Fig. 5): fp8 beats 16-bit only above hidden 4096",
          flush=True)


def phase_te_profile() -> None:
    """Where a te_linear call's device time goes at N=512 and at the
    largest N: one profiler pass of TE_PROFILE_CALLS calls after a
    warm-up step, by kernel group, a call being one launch of the fp8
    product's kernel as the profiler saw them."""
    import collections
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    from repro_torch.benchmarks import te_linear as bl
    from repro_torch.te.fp8 import DelayedScalingRecipe
    from repro_torch.te.linear import init_state, te_linear
    recipe = DelayedScalingRecipe()
    product = TE_KERNEL_GROUPS["product (cuBLAS fp8)"]
    for n in (512, bl.CARD_SIZES[-1]):
        params, x = bl.layer_inputs(n, DEVICE)
        st = init_state(recipe, DEVICE)
        _, st = te_linear(params, st, x, recipe)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1,
                                       active=TE_PROFILE_CALLS,
                                       repeat=1)) as prof:
            for _ in range(1 + TE_PROFILE_CALLS):
                te_linear(params, st, x, recipe)
                torch.cuda.synchronize()
                prof.step()
        # the schedule's step spans are annotations, not kernels
        by_name = collections.Counter({
            k: ms for k, ms in _device_ms_by_kernel(prof, 1).items()
            if not k.startswith("ProfilerStep")})
        gemms = collections.Counter(
            nm for nm, _ in _device_events(prof)
            if any(p in nm for p in product))
        calls = max(gemms.values(), default=0)
        if not calls:
            fail(f"te_linear N={n}: the profiler saw no fp8 product "
                 f"({len(by_name)} kernel names)")
        groups = {k: 0.0 for k in TE_KERNEL_GROUPS}
        for name, ms in by_name.items():
            k = next((k for k, keys in TE_KERNEL_GROUPS.items()
                      if any(key in name for key in keys)), "other")
            groups[k] = groups.get(k, 0.0) + ms / calls
        dev = sum(by_name.values()) / calls
        print(f"[te] profile te_linear N={n}: {calls} calls seen of "
              f"{TE_PROFILE_CALLS} (product launches {dict(gemms)}); device "
              f"{dev:.4f} ms a call: " + "; ".join(
                  f"{k} {ms:.4f}" for k, ms in groups.items())
              + "; kernels (ms a call): " + "; ".join(
                  f"{nm[:150]} {ms / calls:.4f}"
                  for nm, ms in by_name.most_common(12)), flush=True)
        del params, x, st


def phase_memory_te() -> tuple:
    """Phase 11, all of it: the checks and plain versions of (a)-(c),
    then the memory_latency, memory_throughput, te_linear and te_layer
    benchmarks, the main path of this phase, with the counts set to 0
    just before and read just after; then the tables from their rows and
    the te_linear profile.  Returns (results by (kernel, case), the
    memory kernels' launches, B9's launches, B9's launches by body)."""
    import torch
    from repro_torch.benchmarks import run as _registers  # noqa: F401
    from repro_torch.core import bench
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.kernels import memory as mk
    t0 = time.perf_counter()
    sweep, res = phase_memory()
    phase_te_linear_check()
    phase_te_layer()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    mk.reset_launch_counts()
    kfa.reset_launch_counts()
    t1 = time.perf_counter()
    rows = {}
    if bench.run_all(["memory_latency", "memory_throughput", "te_linear",
                      "te_layer"], fail_fast=True,
                     device=torch.device(DEVICE), rows=rows):
        fail("a memory or TE benchmark failed")
    torch.cuda.synchronize()
    launches, flash = mk.launch_counts(), kfa.launch_counts()
    bodies = kfa.body_launches()
    print(f"[te] benchmarks ran in {time.perf_counter() - t1:.1f} s; launch "
          f"counts {launches}, flash_attention {flash} by body {bodies}",
          flush=True)
    if min(launches.values()) <= 0 or flash["flash_attention"] <= 0:
        fail(f"a kernel of the memory / TE path was never launched: "
             f"{launches}, {flash}")
    torch.cuda.empty_cache()
    report_memory(rows, sweep, res)
    report_te(rows)
    phase_te_profile()
    torch.cuda.empty_cache()
    print(f"[te] phase 11 in {time.perf_counter() - t0:.1f} s", flush=True)
    return res, launches, flash["flash_attention"], bodies


# ----------------------------------------------------------------------
# 12. the moe and vlm families
# ----------------------------------------------------------------------

FAMILY_MOE = "moonshot-v1-16b-a3b"     # 64 experts, top-6, 28.06 B params
# its serving depth in (a): 3 of its 48 layers, so that the script
# with phases 2b-17 stays near its parent's time (12 until the
# analyzer's phase, 6 until phase 17; the eager waves are host bound)
FAMILY_MOE_LAYERS = 3
FAMILY_VLM = "internvl2-1b"            # G=7, hd 64, tied embeddings
# its serving depth in (b): 12 of its 24 layers since phase 17 (the
# script's time; the eager waves are host bound); (d) trains all 24
FAMILY_VLM_LAYERS = 12
# (c)'s reduced models card against CPU (dbrx-132b: the moe path with
# LayerNorm and another rope theta)
FAMILY_SMALL = ("moonshot-v1-16b-a3b", "dbrx-132b", "internvl2-1b")
# layers and loss gate (phase_trainer's `descent`) of the families'
# training: moonshot's fp32 parameters and AdamW state at 48 layers
# (449 GB) do not fit, so it is cut to 2; internvl2-1b runs at its full
# depth, where the random stack is chaotic in the reference as in the
# port (its init draws wq at std H^-0.5, saturating the softmax; the
# gradient norm grows from ~1e2 at 2 layers past 1e8 at 24: tests/
# test_torch_moe.py::test_deep_stack_readings_match_the_reference) and
# four steps move its batches' mean loss by about a thousandth: printed
FAMILY_TRAIN_LAYERS = {"moonshot-v1-16b-a3b": (2, "batches"),
                       "internvl2-1b": (24, "")}
FAMILY_TRAIN = (2, 2048)               # B, S of the families' train steps
# device kernel names by kind, for the moe decode step's split
FAMILY_KERNEL_GROUPS = {
    "paged attention": ("paged_attention",),
    "GEMMs (expert, projection, router, unembedding)": (
        "nvjet", "gemm", "gemv", "sm90", "cutlass", "Kernel2", "splitK"),
    "sorts": ("sort", "Sort", "radix", "Radix"),
    "gathers, scatters, searchsorted": ("index", "scatter", "gather",
                                        "searchsorted", "Index"),
}


def _free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _decode_bytes_bound(cfg, B: int, kv_tokens: int) -> tuple:
    """(ms, weight bytes, KV bytes) of the least time a bf16 decode step
    of B slots at `kv_tokens` cached tokens each can take, bytes over
    HBM_BYTES_PER_S: every weight read once (a moe layer at B=8 runs all
    its experts: each takes `moe.capacity` >= 8 rows), but only B rows
    of an untied embedding table; each slot's K and V read and its new
    row written, every layer."""
    n = cfg.param_count()
    if not cfg.tie_embeddings:
        n -= cfg.padded_vocab_size * cfg.d_model - B * cfg.d_model
    weights = 2 * n
    row = 2 * cfg.num_kv_heads * cfg.head_dim * 2          # k and v, bf16
    kv = cfg.num_layers * B * (kv_tokens + 1) * row
    return (weights + kv) / HBM_BYTES_PER_S * 1e3, weights, kv


def _kernel_split(by_name, groups=None, steps: int = SERVE_SPAN,
                  other: str = "other (elementwise, norms, casts)") -> str:
    """Device ms a step by kind of a profiler's {kernel name: ms} over
    `steps` steps, kinds by name patterns (`groups`, default
    FAMILY_KERNEL_GROUPS)."""
    groups = FAMILY_KERNEL_GROUPS if groups is None else groups
    ms_by = {g: 0.0 for g in groups}
    rest = 0.0
    for name, ms in by_name.items():
        g = next((g for g, keys in groups.items()
                  if any(k in name for k in keys)), None)
        if g is None:
            rest += ms
        else:
            ms_by[g] += ms
    ms_by[other] = rest
    return "; ".join(f"{g} {ms / steps:.3f}" for g, ms in ms_by.items())


def _family_spec(cfg, params) -> dict:
    """A cold and a warm K=4 spec wave (phase 5b's traffic) on one
    graphed server: streams rebuilt from the verify steps, paged_decode
    never launched, paged_chunk L x steps in each unit.  Acceptance is
    printed, not held: a moe call couples its rows, drafts included.
    Returns the launches and their split by unit and body."""
    from repro_torch.runtime.server import ChunkedServer, repetitive_requests
    reqs = repetitive_requests(8, cfg.vocab_size, motif_len=8, reps=3,
                               max_output=48, seed=2)
    srv = ChunkedServer(cfg, params, spec_decode=VERIFY_K, **SPEC_SERVER,
                        device=DEVICE)
    L = cfg.num_layers
    total = {"paged_chunk": 0, "by_unit": {"chunk": 0, "verify": 0},
             "by_body": {}}
    for wave in ("cold", "warm"):
        _, st, n, _ = _spec_wave(srv, reqs)
        u = n["by_unit"]
        want = {"chunk": L * int(st["chunk_steps"]),
                "verify": L * int(st["spec_steps"])}
        got = {k: u[k].get("paged_chunk", 0) for k in want}
        print(f"[families] {cfg.name} spec K={VERIFY_K} {wave}: "
              f"{int(st['tokens'])} tokens in {st['seconds']:.2f} s = "
              f"{st['tokens_per_s']:.1f} tok/s; acceptance "
              f"{st['spec_acceptance_rate']:.3f} (printed, not held), "
              f"{st['spec_tokens_per_step']:.2f} tokens a slot a verify "
              f"step, {int(st['spec_steps'])} verify steps; paged_chunk "
              f"{n['paged_chunk']} by unit {got}, paged_decode "
              f"{n['paged_decode']}; streams rebuilt from the verify steps",
              flush=True)
        if n["paged_decode"] or got != want or \
                n["paged_chunk"] != sum(want.values()):
            fail(f"{cfg.name} spec {wave}: paged_decode {n['paged_decode']}"
                 f", paged_chunk by unit {got}, expected {want}")
        total["paged_chunk"] += n["paged_chunk"]
        for k in want:
            total["by_unit"][k] += got[k]
        for b, c in n["by_body"]["paged_chunk"].items():
            total["by_body"][b] = total["by_body"].get(b, 0) + c
    _unit_report(srv, f"{cfg.name} spec K={VERIFY_K}")
    return total


def _moe_kept(idx, E: int, C: int):
    """[T, K] bool: whether each (token, k) assignment of expert ids
    `idx` keeps its row (an expert keeps its first C assignments in
    (token, k) order, as moe.moe_mlp)."""
    import torch
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    start = torch.searchsorted(flat[order], torch.arange(E))
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(flat.numel()) - start[flat[order]]
    return (pos < C).view(idx.shape)


def _moe_mlp_card_vs_cpu(cfg) -> None:
    """One full-width moe_mlp call (one layer's bf16 weights, T=128 rows:
    8 slots x a 16-token chunk) on the card and on the CPU: expert ids
    equal except at a near tie of the CPU's probabilities (ratio within
    2^-5), drops equal, and outputs within four bf16 steps of max |y| on
    every row whose ids and kept assignments are equal on both sides (a
    parted row moves the rows behind it in its experts' runs); its
    graph-replay device ms against the bytes of the weights it reads."""
    import torch
    from repro_torch.models import common, moe
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    p = common.init_params(moe.moe_specs(cfg), gen, torch.device(DEVICE),
                           torch.bfloat16)
    x = torch.randn((8, 16, cfg.d_model), generator=gen,
                    device=DEVICE).to(torch.bfloat16)
    T, C = 128, moe.capacity(cfg, 128)
    with torch.no_grad():
        y, aux = moe.moe_mlp(cfg, p, x)
        _, idx, _ = moe.route(cfg, p, x.reshape(T, -1))
        pc = {k: v.cpu() for k, v in p.items()}
        xc = x.cpu()
        t0 = time.perf_counter()
        yc, auxc = moe.moe_mlp(cfg, pc, xc)
        cpu_s = time.perf_counter() - t0
        _, idxc, _ = moe.route(cfg, pc, xc.reshape(T, -1))
        logits = (xc.reshape(T, -1) @ pc["router"]).float()
        probs = torch.softmax(logits, -1).sort(-1, descending=True).values
        dev_ms = _graph_ms(lambda: moe.moe_mlp(cfg, p, x), 20)
    idx = idx.cpu()
    parted = (idx != idxc).any(-1).nonzero().flatten().tolist()
    for t in parted:
        j = int((idx[t] != idxc[t]).nonzero()[0])
        ratio = float(probs[t, j] / probs[t, j + 1]) - 1
        if ratio > 2.0 ** -5:
            fail(f"moe_mlp card vs CPU: row {t} rank {j} expert ids "
                 f"{idx[t].tolist()} vs {idxc[t].tolist()} away from a tie "
                 f"({ratio:.3e})")
    drops = [int((torch.bincount(i.flatten(), minlength=cfg.num_experts)
                  - C).clamp(min=0).sum()) for i in (idx, idxc)]
    kept = [_moe_kept(i, cfg.num_experts, C) for i in (idx, idxc)]
    held = ((idx == idxc) & (kept[0] == kept[1])).all(-1)
    if not held.any():
        fail("moe_mlp card vs CPU: no row has equal ids and kept rows")
    diff = (y.float().cpu() - yc.float()).reshape(T, -1).abs()
    err = diff[held].max().item()
    top = yc.float().abs().max().item()
    nbytes = sum(v.numel() * v.element_size() for v in p.values()) \
        + 2 * x.numel() * x.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[families] (c) {cfg.name} moe_mlp at full width (E="
          f"{cfg.num_experts}, top-{cfg.top_k}, d {cfg.d_model}, ff "
          f"{cfg.d_ff}), T={T} rows, C={C}: card vs CPU expert ids parted "
          f"in {len(parted)} rows (near ties), drops {drops[0]} / "
          f"{drops[1]}, max |y diff| {err:.4e} on the {int(held.sum())} "
          f"rows with equal ids and kept rows, of max |y| {top:.4f} "
          f"(limit four bf16 steps {4 * 2.0 ** -7 * top:.4e}), aux "
          f"{aux.item():.6f} / {auxc.item():.6f}; card {dev_ms:.4f} device "
          f"ms (graph replay) against the {bound:.4f} ms of its "
          f"{nbytes / 1e9:.3f} GB (bytes), CPU {cpu_s:.2f} s", flush=True)
    if drops[0] != drops[1] or not torch.isfinite(y.float()).all():
        fail(f"moe_mlp card vs CPU: drops {drops} or non-finite output")
    if err > 4 * 2.0 ** -7 * top:
        fail(f"moe_mlp card vs CPU: max |y diff| {err} over four bf16 "
             f"steps of {top}")


def phase_families() -> dict:
    """Phase 12: (a) full-width moonshot-v1-16b-a3b cut to
    FAMILY_MOE_LAYERS layers in bf16 (random weights, seed 0): the
    forward's kernel calls against plain
    (bf16 and an e4m3 pool), phase 5's two waves through ChunkedServer
    in bf16 and with an e4m3 pool (bf16 linears: moe refuses fp8
    linears), graphs captured once and streams equal to a fresh eager
    server's bit for bit, a K=4 spec wave cold and warm, each unit's
    wall and device ms with its top kernels, peak memory, tokens/s, and
    the decode step's device ms against its bytes bound; (b) full-width
    internvl2-1b at FAMILY_VLM_LAYERS: the forward's kernel calls
    against plain and phase 5's waves; (c) reduced moonshot, dbrx and
    internvl2-1b, card against CPU (phase 7's rules, bf16), and one
    full-width moonshot moe_mlp call card against CPU; (d) full-width
    moonshot cut to 2 layers and internvl2-1b at full depth (with
    prefix_embeds; FAMILY_TRAIN_LAYERS): one train step with every B9
    call against plain, then Trainer.run on fresh batches.  Each serve and train main
    path sets its kernels' counts to 0 just before and reads them just
    after.  Returns the paged kernels' and B9's launches."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    t_start = time.perf_counter()
    _free_card()
    paged = {"paged_decode": 0, "paged_chunk": 0, "paged_decode_fp8": 0,
             "paged_chunk_fp8": 0}
    bodies = {k: {} for k in paged}

    def add(launches, by_body):
        for k, v in launches.items():
            if k in paged:
                paged[k] += v
                for b, c in by_body.get(k, {}).items():
                    bodies[k][b] = bodies[k].get(b, 0) + c

    # (a) moonshot-v1-16b-a3b at full width, depth cut
    cfg = dataclasses.replace(get_config(FAMILY_MOE),
                              num_layers=FAMILY_MOE_LAYERS)
    t0 = time.perf_counter()
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[families] (a) {cfg.name} full width, depth cut: "
          f"{cfg.num_layers} layers, d {cfg.d_model}, {cfg.num_experts} "
          f"experts top-{cfg.top_k}, vocab {cfg.vocab_size}: "
          f"{cfg.param_count() / 1e9:.2f} B params "
          f"({api.active_param_count(cfg) / 1e9:.2f} B active), "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated in bf16,"
          f" init {time.perf_counter() - t0:.1f} s", flush=True)
    phase_forward(cfg, params)
    phase_forward(cfg, params, fp8_kv=True)
    served = {}
    for fp8 in (False, True):
        label = f"{cfg.name} {'fp8_kv' if fp8 else 'bf16'}"
        launches, by_body, _, kv_bytes, first = phase_serve(
            cfg, params, fp8=fp8, fp8_linear=False, label=label)
        add(launches, by_body)
        served[label] = first
        del first["rec"]
        _free_card()
    spec = _family_spec(cfg, params)
    add({"paged_chunk": spec["paged_chunk"]},
        {"paged_chunk": spec["by_body"]})
    prof = phase_profile(cfg, params, label=f"{cfg.name} ")
    B, kv_tokens = 8, 128
    bound, w_bytes, kv_b = _decode_bytes_bound(cfg, B, kv_tokens)
    span = prof["decode_span"]
    step_dev = span["device_ms"] / SERVE_SPAN
    print(f"[families] {cfg.name} bf16 decode step (B={B}, {kv_tokens} "
          f"cached tokens a slot, graph replay): {step_dev:.3f} device ms, "
          f"{span['wall_ms'] / SERVE_SPAN:.3f} wall ms, against its bytes "
          f"bound {bound:.3f} ms ({w_bytes / 1e9:.2f} GB of weights + "
          f"{kv_b / 1e9:.4f} GB of KV over {HBM_BYTES_PER_S / 1e12:.2f} "
          f"TB/s; {step_dev / bound:.2f}x); "
          f"{span['kernels'] / SERVE_SPAN:.0f} kernels a step; device ms "
          f"by kind a decode step (profiler): "
          f"{_kernel_split(span['by_name'])}; top kernels "
          f"(ms a step): " + "; ".join(
              f"{n[:56]} {ms / SERVE_SPAN:.3f}"
              for n, ms in span["by_name"].most_common(8)), flush=True)
    for label, first in served.items():
        waves = "; ".join(f"{n} {st['tokens_per_s']:.1f} tok/s"
                          for n, st in first["waves"])
        print(f"[families] {label}: {waves}; peak memory "
              f"{first['peak_gb']:.2f} GB", flush=True)
    del params, served
    _free_card()
    _moe_mlp_card_vs_cpu(cfg)
    _free_card()
    # (b) internvl2-1b at full width and depth
    vcfg = dataclasses.replace(get_config(FAMILY_VLM),
                               num_layers=FAMILY_VLM_LAYERS)
    vparams = api.init(vcfg, 0, device=DEVICE, dtype=torch.bfloat16)
    print(f"[families] (b) {vcfg.name} full width, depth cut: "
          f"{vcfg.num_layers} of {get_config(FAMILY_VLM).num_layers} "
          f"layers, d {vcfg.d_model}, H {vcfg.num_heads} "
          f"over KH {vcfg.num_kv_heads} (G="
          f"{vcfg.num_heads // vcfg.num_kv_heads}), hd {vcfg.head_dim}, "
          f"tied embeddings: {vcfg.param_count() / 1e9:.3f} B params",
          flush=True)
    phase_forward(vcfg, vparams)
    launches, by_body, _, _, first = phase_serve(
        vcfg, vparams, label=f"{vcfg.name} bf16")
    add(launches, by_body)
    print(f"[families] {vcfg.name} bf16: " + "; ".join(
        f"{n} {st['tokens_per_s']:.1f} tok/s" for n, st in first["waves"])
        + f"; peak memory {first['peak_gb']:.2f} GB", flush=True)
    del vparams, first
    _free_card()
    # (c) reduced models, card against CPU
    for arch in FAMILY_SMALL:
        phase_small(False, arch)
    # (d) training
    flash, flash_bodies = {"flash_attention": 0}, {}
    Bt, St = FAMILY_TRAIN
    for base, extra in (
            (cfg, None),
            (get_config(FAMILY_VLM),
             {"prefix_embeds": ((vcfg.num_prefix_tokens,
                                 vcfg.d_model), np.float32)})):
        layers, descent = FAMILY_TRAIN_LAYERS[base.name]
        tcfg = _train_config(base, layers)
        phase_train_step(tcfg, B=Bt, S=St, extra=extra)
        _free_card()
        n, b = phase_trainer(tcfg, B=Bt, S=St, extra=extra, descent=descent)
        flash["flash_attention"] += n["flash_attention"]
        for k, v in b.items():
            flash_bodies[k] = flash_bodies.get(k, 0) + v
        _free_card()
    print(f"[families] phase 12 in {time.perf_counter() - t_start:.1f} s; "
          f"paged launches {paged}, by body {bodies}; flash_attention "
          f"{flash['flash_attention']} by body {flash_bodies}", flush=True)
    return {"paged": paged, "paged_bodies": bodies,
            "flash": flash["flash_attention"], "flash_bodies": flash_bodies}


# ----------------------------------------------------------------------
# 13. the state-space families
# ----------------------------------------------------------------------

SSM_ARCH = "falcon-mamba-7b"           # Mamba-1: 64 layers, 7.27 B params
HYBRID_ARCH = "zamba2-2.7b"            # Mamba-2 + a shared block at hd 80
SSM_PROMPT = (8, 512)                  # B, S of the prefills
SSM_DECODE = {SSM_ARCH: 64, HYBRID_ARCH: 32}    # greedy steps after them
# falcon-mamba-7b: the prompt's last SSM_TAIL tokens decoded one by one
# from the state after the rest, against the chunked forward's rows (the
# one-token and the chunked scan multiply in other orders; the reduced
# model reads 0 bf16 steps, on the CPU and card against CPU).  The
# random 64-layer stack is chaotic: its bf16 forward lies 45-103 bf16
# steps (2**-7 of max |logit| each) from the same forward with float32
# activations, and the tail steps part from the rows as they go (10.1
# steps at the first, 62 by the ninth, on an NVIDIA H100 80GB HBM3 at
# 700.00 W).
# So the first step is held to SSM_TAIL_STEPS and the rest printed, with
# the stack's own noise (slot 0)
SSM_TAIL = 16
SSM_TAIL_STEPS = 16.0
SSM_SMALL = (SSM_ARCH, HYBRID_ARCH)
SSM_SMALL_SHAPE = (4, 24, 16)          # B, prompt, decode steps
# card against CPU at the reduced size: logits within max(SSM_SMALL_STEPS,
# SSM_NOISE x the CPU's own bf16-vs-float32 distance) bf16 steps (the
# reduced zamba2 is chaotic in bf16: tests/test_torch_hybrid.py)
SSM_SMALL_STEPS = 4.0
SSM_NOISE = 3.0
# layers of the cut-depth trainings (B, S = FAMILY_TRAIN): fp32
# parameters and AdamW moments at full depth need 116 GB (falcon-mamba)
# and 38 GB plus activations (zamba2; one super-block of 6 layers, 12
# until the analyzer's phase)
SSM_TRAIN_LAYERS = {SSM_ARCH: 2, HYBRID_ARCH: 6}   # falcon 4 to PR 30
SSM_REPLAYS = 20                       # replays a device-ms reading
SSM_KERNEL_GROUPS = {
    "GEMMs (projections, unembedding)": (
        "nvjet", "gemm", "gemv", "sm90", "cutlass", "Kernel2", "splitK"),
    "reductions (norms, readout, softmax)": ("reduce", "Reduce", "softmax"),
    "copies, cats, scatters": ("copy", "Copy", "cat", "Cat", "scatter",
                               "index", "gather"),
}
SSM_OTHER = "other elementwise (scan, exp, silu, casts)"


def _tree_clone(tree):
    from repro_torch.core.tree import tree_map
    return tree_map(lambda t: t.clone(), tree)


def _tree_copy_(dst, src) -> None:
    from repro_torch.core.tree import leaves
    for d, t in zip(leaves(dst), leaves(src)):
        d.copy_(t)


def _tree_equal(a, b) -> bool:
    import torch
    from repro_torch.core.tree import leaves
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def _tree_bytes(tree) -> int:
    from repro_torch.core.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def _bf16_steps(want, got) -> float:
    """max |got - want| in bf16 steps of want's scale (2**-7 max |want|)."""
    want, got = want.float().cpu(), got.float().cpu()
    return ((got - want).abs().max()
            / (2.0 ** -7 * want.abs().max())).item()


def _ssm_bytes_bound(cfg, params, cache, B: int, kv_read: int) -> tuple:
    """(ms, weight bytes, state bytes) of the least time a decode step
    of B sequences can take, bytes over HBM_BYTES_PER_S: every weight
    read once (the hybrid's shared block once a super-block), but only B
    rows of an untied embedding table; the recurrent states read and
    written; the hybrid's K and V read at `kv_read` positions a slot
    and a row of each written, a super-block."""
    from repro_torch.models import hybrid
    weights = _tree_bytes(params)
    emb = params["embed"]
    if not cfg.tie_embeddings:
        weights -= (emb.shape[0] - B) * emb.shape[1] * emb.element_size()
    state = 0
    if cfg.family == "hybrid":
        ns = hybrid.n_superblocks(cfg)
        weights += (ns - 1) * _tree_bytes(params["shared"])
        state = 2 * _tree_bytes(cache["mamba"])
        row = cache["k"][0, :, 0].numel() * cache["k"].element_size()
        state += ns * 2 * row * (kv_read + 1)
    else:
        state = 2 * _tree_bytes(cache)
    return (weights + state) / HBM_BYTES_PER_S * 1e3, weights, state


def _decode_unit(cfg, params, cache, tok, pos: int, label: str) -> tuple:
    """A WorkUnit of api.decode_step over `cache` (call 1 eager on a side
    stream, call 2 captured and replayed), each held bit for bit to an
    eager step from the same state (logits and every cache leaf); the
    eager step's wall ms, the replay's device ms (CUDA events over
    SSM_REPLAYS replays), its kernels and their device ms by kind
    (torch.profiler over 5 replays).  `cache` is left as it was given.
    Returns (unit, readings)."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.runtime.graphs import WorkUnit
    unit = WorkUnit("decode_step", lambda t, p: (api.decode_step(
        cfg, params, cache, t, p)[0],), DEVICE)
    ops = (tok.cpu().numpy().astype(np.int32), np.array([pos], np.int32))
    snap = _tree_clone(cache)
    eager = _tree_clone(snap)
    want, _ = api.decode_step(cfg, params, eager, tok, pos)
    walls = []
    for _ in range(3):
        probe = _tree_clone(snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(cfg, params, probe, tok, pos)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        del probe
    for call in ("eager (side stream)", "captured and replayed"):
        _tree_copy_(cache, snap)
        got = unit.run(*ops)[0]
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and _tree_equal(cache, eager)):
            fail(f"{label} decode step, {call}: logits or state differ "
                 f"from the eager step's")
    _tree_copy_(cache, snap)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SSM_REPLAYS):
        unit.graph.replay()
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / SSM_REPLAYS
    with _device_profile() as prof:
        for _ in range(5):
            unit.graph.replay()
        torch.cuda.synchronize()
    by_name = _device_ms_by_kernel(prof, 5)
    kernels = len(_device_events(prof)) / 5
    _tree_copy_(cache, snap)
    del snap, eager
    return unit, {"wall_ms": sorted(walls)[1], "device_ms": dev_ms,
                  "by_name": by_name, "kernels": kernels}


def _greedy(unit, tok, pos: int, steps: int, vocab: int) -> list:
    """`steps` greedy tokens through the unit's replays from `tok` at
    `pos`: each in the vocabulary, each step's logits finite."""
    import numpy as np
    import torch
    out = []
    for i in range(steps):
        logits = unit.run(tok.cpu().numpy().astype(np.int32),
                          np.array([pos + i], np.int32))[0]
        if not torch.isfinite(logits.float()).all():
            fail(f"decode step {i} gave non-finite logits")
        tok = logits.argmax(-1).to(torch.int32)
        out.append(tok.cpu())
    toks = torch.stack(out, 1)
    if not ((toks >= 0) & (toks < vocab)).all():
        fail("a greedy token fell outside the vocabulary")
    return toks


def _report_decode(label, cfg, params, cache, B, kv_read, unit_stats,
                   prefill_ms, S, peak) -> dict:
    bound, w, st = _ssm_bytes_bound(cfg, params, cache, B, kv_read)
    dev = unit_stats["device_ms"]
    top = "; ".join(f"{n[:56]} {ms:.3f}"
                    for n, ms in unit_stats["by_name"].most_common(6))
    print(f"[ssm] {label}: prefill B={B} S={S} {prefill_ms:.1f} ms = "
          f"{B * S / prefill_ms * 1e3:.0f} tokens/s; decode step (B={B}) "
          f"eager {unit_stats['wall_ms']:.2f} wall ms, graph replay "
          f"{dev:.3f} device ms against its bytes bound {bound:.3f} ms "
          f"({w / 1e9:.3f} GB of weights + {st / 1e6:.1f} MB of state"
          f"{' and KV' if cfg.family == 'hybrid' else ''} over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {dev / bound:.2f}x), "
          f"{unit_stats['kernels']:.0f} kernels a step; device ms by kind "
          f"a step (profiler): {_kernel_split(unit_stats['by_name'], SSM_KERNEL_GROUPS, 1, SSM_OTHER)}; top "
          f"kernels (ms a step): {top}; peak memory {peak / 1e9:.2f} GB",
          flush=True)
    return {"prefill_ms": prefill_ms, "device_ms": dev, "bound_ms": bound}


def _ssm_model(name: str, seed: int = 0):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    cfg = get_config(name)
    t0 = time.perf_counter()
    params = api.init(cfg, seed, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[ssm] {name} full width and depth: {cfg.num_layers} layers, d "
          f"{cfg.d_model}, d_inner {cfg.d_inner}, N {cfg.ssm_state}, vocab "
          f"{cfg.vocab_size}: {cfg.param_count() / 1e9:.3f} B params, "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB allocated in bf16, "
          f"init {time.perf_counter() - t0:.1f} s", flush=True)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    B, S = SSM_PROMPT
    toks = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEVICE, dtype=torch.int32)
    return cfg, params, toks


def _timed_prefill(cfg, params, toks, max_len):
    """api.prefill on a fresh cache twice (the second timed): equal
    logits.  Returns (logits, cache, ms)."""
    import torch
    from repro_torch.models import api
    B = toks.shape[0]
    first, _ = api.prefill(cfg, params, {"tokens": toks},
                           api.init_cache(cfg, B, max_len, device=DEVICE))
    cache = api.init_cache(cfg, B, max_len, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = api.prefill(cfg, params, {"tokens": toks}, cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not torch.equal(first, logits):
        fail(f"{cfg.name} prefill is not bitwise repeatable")
    return logits, cache, ms


def _phase_falcon() -> dict:
    """13(a)."""
    import torch
    from repro_torch.models import api, ssm_lm, transformer
    cfg, params, toks = _ssm_model(SSM_ARCH)
    B, S = SSM_PROMPT
    steps = SSM_DECODE[SSM_ARCH]
    torch.cuda.reset_peak_memory_stats()
    logits, cache, prefill_ms = _timed_prefill(cfg, params, toks, S + steps)
    print(f"[ssm] {cfg.name}: prefill {prefill_ms:.1f} ms", flush=True)
    t0 = time.perf_counter()
    with torch.no_grad():
        h, _ = ssm_lm.forward(cfg, params, toks)
        last = transformer.logits_fn(cfg, params, h[:, -1:])[:, 0]
        rows = transformer.logits_fn(cfg, params, h[:, S - SSM_TAIL:])
        with _Float32Rows():
            h, _ = ssm_lm.forward(cfg, params, toks[:1])
            rows32 = transformer.logits_fn(cfg, params, h[:, S - SSM_TAIL:])
    del h
    noise = [_bf16_steps(rows32[0, j], rows[0, j]) for j in range(SSM_TAIL)]
    del rows32
    print(f"[ssm] {cfg.name}: forward in bf16 and (slot 0) with float32 "
          f"activations ({time.perf_counter() - t0:.1f} s): the bf16 rows' "
          f"own noise at the last {SSM_TAIL} positions, bf16 steps of max "
          f"|logit|: {', '.join(f'{x:.2f}' for x in noise)}", flush=True)
    if not torch.equal(logits, last):
        fail(f"{cfg.name}: prefill's last logits differ from the forward's "
             f"(max |diff| {(logits.float() - last.float()).abs().max()})")
    print(f"[ssm] {cfg.name}: api.prefill's last-position logits equal "
          f"ssm_lm.forward + logits_fn's bit for bit", flush=True)
    # the prompt's tail, one token at a time, against the forward's rows
    t0 = time.perf_counter()
    tail = api.init_cache(cfg, B, S, device=DEVICE)
    api.prefill(cfg, params, {"tokens": toks[:, :S - SSM_TAIL]}, tail)
    got = []
    for j in range(SSM_TAIL):
        p = S - SSM_TAIL + j
        lg, tail = api.decode_step(cfg, params, tail, toks[:, p], p)
        got.append(_bf16_steps(rows[:, j], lg))
    del tail, rows
    bar = SSM_TAIL_STEPS
    print(f"[ssm] {cfg.name}: the prompt's last {SSM_TAIL} tokens decoded "
          f"one by one from the state after position {S - SSM_TAIL - 1} "
          f"({time.perf_counter() - t0:.1f} s), against the chunked "
          f"forward's rows, in bf16 steps of max |logit|: "
          f"{', '.join(f'{x:.2f}' for x in got)} (the first held to "
          f"{bar:.2f}, the rest printed)", flush=True)
    if not got[0] <= bar:
        fail(f"{cfg.name}: the first tail step is {got[0]:.2f} bf16 steps "
             f"from the forward's row (limit {bar:.2f})")
    tok = logits.argmax(-1).to(torch.int32)
    unit, st = _decode_unit(cfg, params, cache, tok, S, cfg.name)
    print(f"[ssm] {cfg.name}: the decode step's graph replay gives the "
          f"eager step's logits and state bit for bit", flush=True)
    gen = _greedy(unit, tok, S, steps, cfg.vocab_size)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] {cfg.name}: {steps} greedy steps through the replays, "
          f"slot 0's first tokens {gen[0, :12].tolist()}", flush=True)
    out = _report_decode(cfg.name, cfg, params, cache, B, 0, st,
                         prefill_ms, S, peak)
    del params, cache, unit
    _free_card()
    return out


def _phase_zamba2() -> dict:
    """13(b).  Returns its readings and B9's launches on the main
    path (the checked prefill), by body too."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import api, hybrid
    cfg, params, toks = _ssm_model(HYBRID_ARCH)
    B, S = SSM_PROMPT
    steps = SSM_DECODE[HYBRID_ARCH]
    ns = hybrid.n_superblocks(cfg)
    torch.cuda.reset_peak_memory_stats()
    kfa.reset_launch_counts()
    with _CheckedFlash() as chk:
        first, _ = api.prefill(cfg, params, {"tokens": toks},
                               api.init_cache(cfg, B, S, device=DEVICE))
        torch.cuda.synchronize()
    launches = kfa.launch_counts()["flash_attention"]
    bodies = kfa.body_launches()
    print(f"[ssm] {cfg.name}: api.prefill (the forward) ran B9 "
          f"{launches} times, by body {bodies}, q/k/v [{B}, {S}, "
          f"{cfg.num_heads}/{cfg.num_kv_heads}, {cfg.head_dim}]; each call "
          f"against its plain version: max |o - plain| / max |o| "
          f"{chk.worst:.3e} (limit {FLASH_BF16_STEP:.3e}), lse "
          f"{chk.lse:.3e} (limit {FLASH_F32_LIMIT:.0e})", flush=True)
    if launches != ns or bodies["mma_sync"] != ns or chk.calls != ns:
        fail(f"{cfg.name} prefill: B9 launched {launches} times ({bodies}),"
             f" checked {chk.calls}, not {ns} on mma_sync")
    if chk.worst > FLASH_BF16_STEP or chk.lse > FLASH_F32_LIMIT:
        fail(f"{cfg.name} prefill: a B9 call differs from its plain version")
    flash = _flash_at(next(iter(chk.first.values())), chk.worst)
    logits, cache, prefill_ms = _timed_prefill(cfg, params, toks, S + steps)
    if not torch.equal(first, logits):
        fail(f"{cfg.name}: the checked prefill's logits differ")
    if not all(not leaf.any() for leaf in (cache["k"], cache["v"],
                                           *cache["mamba"].values())):
        fail(f"{cfg.name}: api.prefill wrote into the cache")
    # the serving path of the family: the prompt fed token by token from
    # state zero through the decode step's graph, then greedy steps
    unit, st = _decode_unit(cfg, params, cache, toks[:, 0], 0, cfg.name)
    print(f"[ssm] {cfg.name}: the decode step's graph replay gives the "
          f"eager step's logits, states and KV bit for bit", flush=True)
    t0 = time.perf_counter()
    for t in range(S):
        lg = unit.run(toks[:, t].cpu().numpy().astype(np.int32),
                      np.array([t], np.int32))[0]
    torch.cuda.synchronize()
    feed_s = time.perf_counter() - t0
    print(f"[ssm] {cfg.name}: the {S}-token prompt fed through the decode "
          f"step's replays in {feed_s:.2f} s; its last logits "
          f"{_bf16_steps(logits, lg):.2f} bf16 steps from the prefill's "
          f"(printed)", flush=True)
    gen = _greedy(unit, lg.argmax(-1).to(torch.int32), S, steps,
                  cfg.vocab_size)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"[ssm] {cfg.name}: {steps} greedy steps, slot 0's first tokens "
          f"{gen[0, :12].tolist()}", flush=True)
    out = _report_decode(cfg.name, cfg, params, cache, B, S + steps // 2,
                         st, prefill_ms, S, peak)
    del params, cache, unit
    _free_card()
    return out, launches, bodies, flash


def _flash_at(qkvkw, rel_err: float) -> dict:
    """B9 at the shared block's shape, on the prefill's first q, k, v:
    kernel ms (CUDA events, back to back), plain ms, the ms of
    scaled_dot_product_attention (a yardstick the port never calls)
    and the bound (phase 10's rule)."""
    from repro_torch.kernels import flash_attention as kfa
    q, k, v, kw = qkvkw
    B, S, H, hd = q.shape
    KH = k.shape[2]
    causal, window = kw.get("causal", True), kw.get("window", 0)
    q_offset = kw.get("q_offset", 0)
    ms = _time_ms(lambda: kfa.flash_attention_fwd(q, k, v, **kw), 20)
    plain_ms = _time_ms(lambda: kfa.flash_attention_fwd_plain(q, k, v, **kw),
                        3, warm=1)
    lib_ms = _time_ms(_sdpa_yardstick(q, k, v, causal, window, q_offset), 20)
    bound_ms, bound_by = _flash_bound("bfloat16", B, S, S, H, KH, hd, causal,
                                      window, q_offset, q.element_size())
    tflops = 4 * hd * _attended_pairs(B, S, S, H, causal, window,
                                      q_offset) / (ms * 1e-3) / 1e12
    print(f"[ssm] B9 at the shared block's shape (B={B}, S={S}, H={H}, "
          f"KH={KH}, hd={hd}, causal, bf16, body {kfa.body(q.dtype, hd)}): "
          f"{ms:.4f} ms ({tflops:.1f} TFLOP/s), plain {plain_ms:.4f} ms, "
          f"SDPA {lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}); "
          f"max |o - plain| / max |o| over the prefill's calls "
          f"{rel_err:.3e}", flush=True)
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "rel_err": rel_err}


class _Float32Rows:
    """Within the block the recurrent and encoder-decoder families'
    embeddings give float32 rows (forward and decode), so the
    activations stay float32 whatever the weights' dtype (the tests'
    `_keep_f32_rows`; encdec's with float32 frames)."""

    def __enter__(self):
        import torch.nn.functional as F
        from repro_torch.models import encdec, hybrid, ssm_lm
        fns = {"embed_tokens": (lambda cfg, params, tokens,
                                prefix_embeds=None: F.embedding(
                                    tokens.long(), params["embed"]).float()),
               "_embed": (lambda params, tokens:
                          params["embed"][tokens.long()].float())}
        self.saved = [(m, n, getattr(m, n)) for m in (ssm_lm, hybrid, encdec)
                      for n in fns if hasattr(m, n)]
        for m, n, _ in self.saved:
            setattr(m, n, fns[n])
        return self

    def __exit__(self, *exc):
        for m, n, f in self.saved:
            setattr(m, n, f)


def _small_run(cfg, params, toks, steps, device, dtype):
    """api.prefill, then `steps` greedy decode steps: [(logits on the
    CPU, token)] a step, each device feeding its own argmax."""
    import torch
    from repro_torch.models import api
    B, S = toks.shape
    cache = api.init_cache(cfg, B, S + steps, dtype, device=device)
    lg, cache = api.prefill(cfg, params, {"tokens": toks.to(device)}, cache)
    out = []
    for i in range(steps + 1):
        tok = lg.argmax(-1).to(torch.int32)
        out.append((lg.float().cpu(), tok.cpu()))
        if i < steps:
            lg, cache = api.decode_step(cfg, params, cache, tok, S + i)
    return out


def _phase_ssm_small(arch: str) -> None:
    """13(c): the reduced model (float32 weights, bf16 activations) on
    the card and on the CPU, the same prompt: every greedy step's tokens
    equal until a step where the CPU's top-2 margin is within
    SMALL_MARGIN (nothing is held after it), and the logits before it
    within max(SSM_SMALL_STEPS, SSM_NOISE x the CPU's own distance from
    its float32 run) bf16 steps."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.models import api
    cfg = reduced_config(arch)
    B, S, steps = SSM_SMALL_SHAPE
    cpu_params = api.init(cfg, 0, device="cpu")
    params = _tree_to(cpu_params, DEVICE)
    toks = torch.randint(0, cfg.vocab_size, (B, S),
                         generator=torch.Generator().manual_seed(7),
                         dtype=torch.int32)
    card = _small_run(cfg, params, toks, steps, DEVICE, torch.bfloat16)
    cpu = _small_run(cfg, cpu_params, toks, steps, "cpu", torch.bfloat16)
    with _Float32Rows():
        f32 = _small_run(cfg, cpu_params, toks, 0, "cpu", torch.float32)
    noise = _bf16_steps(f32[0][0], cpu[0][0])
    bar = max(SSM_SMALL_STEPS, SSM_NOISE * noise)
    worst, parted = 0.0, None
    for i, ((lc, tc), (lg, tg)) in enumerate(zip(cpu, card)):
        worst = max(worst, _bf16_steps(lc, lg))
        if not torch.equal(tc, tg):
            top2 = lc.topk(2, -1).values
            margin = (top2[:, 0] - top2[:, 1])[tc != tg].max().item()
            if margin > SMALL_MARGIN:
                fail(f"{cfg.name} card vs CPU: step {i} parts at a top-2 "
                     f"margin {margin:.4f} > {SMALL_MARGIN}")
            parted = (i, margin)
            break
    print(f"[ssm] (c) {cfg.name} card vs CPU, B={B}, prompt {S}, {steps} "
          f"greedy steps: logits within {worst:.2f} bf16 steps of max "
          f"|logit| (limit {bar:.2f}: the CPU's bf16 run lies {noise:.2f} "
          f"steps from its float32 run), "
          + ("streams equal" if parted is None else
             f"parted at step {parted[0]} at a CPU top-2 margin "
             f"{parted[1]:.4f} (<= {SMALL_MARGIN})"), flush=True)
    if worst > bar:
        fail(f"{cfg.name} card vs CPU: logits {worst:.2f} bf16 steps apart "
             f"(limit {bar:.2f})")


def phase_ssm_families() -> dict:
    """Phase 13: (a) full-width, full-depth falcon-mamba-7b (random bf16
    weights, seed 0): api.prefill on B=8 prompts of 512 tokens, equal
    bit for bit to ssm_lm.forward + logits_fn at the last position; the
    prompt's last 16 tokens decoded one by one from the state after the
    rest, against the forward's rows; the decode step as a WorkUnit
    (eager, then one CUDA graph), equal bit for bit to an eager step;
    64 greedy steps through the replays; prefill ms and tokens/s, the
    step's eager wall ms and replay device ms against its bytes bound,
    its kernels by kind, peak memory.  (b) zamba2-2.7b the same way:
    api.prefill (the forward) with every B9 call (hd 80, mma_sync) held
    to its plain version, then the prompt fed token by token from state
    zero and 32 greedy steps through the graph.  (c) the reduced models,
    card against CPU.  (d) falcon-mamba-7b cut to 2 layers and zamba2
    cut to 1 super-block, full width, B=2, S=2048: phase 10's checked
    step and Trainer.run on fresh batches (the mean loss of the run's
    own batches must fall).  The B9 launches of the main paths (the
    prefill, the trainer) are counted from 0.  Returns them."""
    from repro_torch.configs import get_config
    from repro_torch.models import hybrid
    t_start = time.perf_counter()
    _free_card()
    falcon = _phase_falcon()
    print(f"[ssm] (a) in {time.perf_counter() - t_start:.1f} s", flush=True)
    zamba, launches, bodies, flash_hd80 = _phase_zamba2()
    print(f"[ssm] (a)-(b) in {time.perf_counter() - t_start:.1f} s",
          flush=True)
    for arch in SSM_SMALL:
        _phase_ssm_small(arch)
    flash = {"prefill": launches, "trainer": 0}
    flash_bodies = dict(bodies)
    Bt, St = FAMILY_TRAIN
    for arch in (SSM_ARCH, HYBRID_ARCH):
        tcfg = _train_config(get_config(arch), SSM_TRAIN_LAYERS[arch])
        calls = (2 * hybrid.n_superblocks(tcfg) if tcfg.family == "hybrid"
                 else 0)
        phase_train_step(tcfg, B=Bt, S=St, flash_calls=calls)
        _free_card()
        n, b = phase_trainer(tcfg, B=Bt, S=St, descent="batches",
                             flash_calls=calls, flash_body="mma_sync")
        if calls:
            print(f"[ssm] {tcfg.name} ({tcfg.num_layers} layers, "
                  f"{calls // 2} super-blocks): B9 {calls} calls a step, "
                  f"{calls // 2} in the forward and {calls // 2} in the "
                  f"remat recompute of the shared block", flush=True)
        flash["trainer"] += n["flash_attention"]
        for k, v in b.items():
            flash_bodies[k] = flash_bodies.get(k, 0) + v
        _free_card()
    print(f"[ssm] phase 13 in {time.perf_counter() - t_start:.1f} s; "
          f"{SSM_ARCH} prefill {falcon['prefill_ms']:.1f} ms, decode "
          f"{falcon['device_ms']:.3f} / bound {falcon['bound_ms']:.3f} ms; "
          f"{HYBRID_ARCH} prefill {zamba['prefill_ms']:.1f} ms, decode "
          f"{zamba['device_ms']:.3f} / bound {zamba['bound_ms']:.3f} ms; "
          f"flash_attention {flash} by body {flash_bodies}", flush=True)
    return {"flash": flash["prefill"] + flash["trainer"],
            "flash_by_path": flash, "flash_bodies": flash_bodies,
            "flash_hd80": flash_hd80}


# ----------------------------------------------------------------------
# 14. the encoder-decoder family
# ----------------------------------------------------------------------

ENCDEC_ARCH = "whisper-small"          # 12 + 12 layers, d 768, hd 64
ENCDEC_PREFILL = 8                     # B of 30-second windows (1500 frames)
ENCDEC_TRAIN = 2                       # B of the training step
ENCDEC_EAGER_STEPS = 16                # graph replays held bit for bit
ENCDEC_SOT = 50258                     # whisper's start-of-transcript id
ENCDEC_REPLAYS = 20                    # replays a device-ms reading
# B9 launches a training step: 12 encoder, 12 decoder self and 12
# cross-attention calls, each again in the remat recompute
ENCDEC_SMALL_SHAPE = (4, 24, 15)       # B, frames, greedy decode steps


def _encdec_checked(chk, what: str, want: int) -> None:
    """Phase 14's bars on a `_CheckedFlash` run: `want` calls, each o
    within one bf16 step of max |o| and lse within 1e-4."""
    print(f"[encdec] {what}: {chk.calls} B9 calls, each against its "
          f"plain version: max |o - plain| / max |o| {chk.worst:.3e} "
          f"(limit {FLASH_BF16_STEP:.3e}), lse {chk.lse:.3e} (limit "
          f"{FLASH_F32_LIMIT:.0e})", flush=True)
    if chk.calls != want:
        fail(f"{what}: {chk.calls} B9 calls, not {want}")
    if chk.worst > FLASH_BF16_STEP or chk.lse > FLASH_F32_LIMIT:
        fail(f"{what}: a B9 call differs from its plain version")


def _encdec_bytes_bound(cfg, params, cache, B: int, kv_read: int) -> tuple:
    """(ms, weight bytes, KV bytes) of the least time a decode step of B
    sequences can take, bytes over HBM_BYTES_PER_S: the decoder's
    weights and the tied embedding (the unembedding reads every row)
    read once, B rows of dec_pos; the self K and V read at `kv_read`
    positions a sequence and a row of each written, every layer; the
    cross K and V read whole; the logits written."""
    elt = cache["k"].element_size()
    L, _, _, KH, hd = cache["k"].shape
    weights = (_tree_bytes(params["dec_layers"])
               + _tree_bytes(params["final_norm"])
               + _tree_bytes(params["embed"])
               + B * cfg.d_model * params["dec_pos"].element_size())
    kv = 2 * L * B * (kv_read + 1) * KH * hd * elt
    kv += _tree_bytes({"xk": cache["xk"], "xv": cache["xv"]})
    logits = B * cfg.vocab_size * 2
    return ((weights + kv + logits) / HBM_BYTES_PER_S * 1e3, weights, kv)


def _encdec_model():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    cfg = get_config(ENCDEC_ARCH)
    t0 = time.perf_counter()
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.bfloat16)
    frames = api.make_batch(cfg, ShapeConfig(
        "prefill_30s", cfg.max_source_len, ENCDEC_PREFILL, "prefill"), 0,
        device=DEVICE)["frames"]
    torch.cuda.synchronize()
    print(f"[encdec] {cfg.name} full width and depth: {cfg.enc_layers} + "
          f"{cfg.dec_layers} layers, d {cfg.d_model}, H = KH = "
          f"{cfg.num_heads}, hd {cfg.head_dim}, ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size} (padded {cfg.padded_vocab_size}): "
          f"{cfg.param_count() / 1e9:.3f} B params in bf16, frames "
          f"{list(frames.shape)} {frames.dtype}, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return cfg, params, frames


def _encdec_prefill(cfg, params, frames) -> tuple:
    """14(b): api.prefill with every B9 call checked (the main path:
    counts from 0 around it), then twice unchecked, the second timed;
    the three encoder outputs and cross K/V equal.  Returns (cache,
    launches, bodies, ms)."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import api
    B, S = frames.shape[:2]
    kfa.reset_launch_counts()
    with _CheckedFlash() as chk:
        enc0, c0 = api.prefill(cfg, params, {"frames": frames},
                               api.init_cache(cfg, B, cfg.max_target_len,
                                              device=DEVICE))
        torch.cuda.synchronize()
    launches = kfa.launch_counts()["flash_attention"]
    bodies = kfa.body_launches()
    _encdec_checked(chk, f"{cfg.name} api.prefill (B={B}, {S} frames)",
                    cfg.enc_layers)
    if launches != cfg.enc_layers or bodies["wgmma"] != cfg.enc_layers:
        fail(f"{cfg.name} prefill: B9 launched {launches} times "
             f"({bodies}), not {cfg.enc_layers} on wgmma")
    api.prefill(cfg, params, {"frames": frames},
                api.init_cache(cfg, B, cfg.max_target_len, device=DEVICE))
    cache = api.init_cache(cfg, B, cfg.max_target_len, device=DEVICE)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    enc, cache = api.prefill(cfg, params, {"frames": frames}, cache)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    if not (torch.equal(enc, enc0) and _tree_equal(cache, c0)):
        fail(f"{cfg.name} prefill is not bitwise repeatable")
    if not torch.isfinite(enc.float()).all() or \
            tuple(enc.shape) != (B, S, cfg.d_model):
        fail(f"{cfg.name} prefill: encoder output {tuple(enc.shape)} "
             "non-finite or misshapen")
    if cache["xk"].shape[2] != S:
        fail(f"{cfg.name} prefill: cross K/V of {cache['xk'].shape[2]} rows,"
             f" not {S}")
    print(f"[encdec] {cfg.name}: api.prefill B={B} x {S} frames "
          f"{ms:.2f} ms = {B * S / ms * 1e3:.0f} frames/s; B9 launches "
          f"{launches} by body {bodies}", flush=True)
    del enc0, c0, enc
    return cache, launches, bodies, ms


def _encdec_decode(cfg, params, cache) -> dict:
    """14(c): the decode step as one CUDA graph (runtime.graphs.WorkUnit:
    call 1 eager on a side stream, call 2 captured and replayed), greedy
    from the start-of-transcript token to max_target_len: the first
    ENCDEC_EAGER_STEPS steps' logits equal an eager run's bit for bit,
    every step's logits finite and tokens in the vocabulary; then the
    replay's device ms with the cache full against its bytes bound, its
    kernels a step, and an eager step's wall ms."""
    import numpy as np
    import torch
    from repro_torch.models import api
    from repro_torch.runtime.graphs import WorkUnit
    B = cache["k"].shape[1]
    steps = cfg.max_target_len - 1
    snap = _tree_clone(cache)
    tok0 = torch.full((B,), ENCDEC_SOT, dtype=torch.int32, device=DEVICE)
    eager, tok = [], tok0
    probe = _tree_clone(snap)
    for i in range(ENCDEC_EAGER_STEPS):
        lg, _ = api.decode_step(cfg, params, probe, tok, i)
        eager.append(lg)
        tok = lg.argmax(-1).to(torch.int32)
    walls = []
    for _ in range(3):
        probe = _tree_clone(snap)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        api.decode_step(cfg, params, probe, tok0, 0)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    del probe
    unit = WorkUnit("decode_step", lambda t, p: (api.decode_step(
        cfg, params, cache, t, p)[0],), DEVICE)
    tok, out = tok0, []
    t0 = time.perf_counter()
    for i in range(steps):
        lg = unit.run(tok.cpu().numpy().astype(np.int32),
                      np.array([i], np.int32))[0]
        if i < ENCDEC_EAGER_STEPS and not torch.equal(lg, eager[i]):
            fail(f"{cfg.name} decode step {i} ({'eager call' if i == 0 else 'capture' if i == 1 else 'replay'}): "
                 f"logits differ from the eager step's (max |diff| "
                 f"{(lg.float() - eager[i].float()).abs().max().item()})")
        if not torch.isfinite(lg.float()).all():
            fail(f"{cfg.name} decode step {i} gave non-finite logits")
        tok = lg.argmax(-1).to(torch.int32)
        out.append(tok.cpu())
    torch.cuda.synchronize()
    loop_s = time.perf_counter() - t0
    toks = torch.stack(out, 1)
    if not ((toks >= 0) & (toks < cfg.vocab_size)).all():
        fail("a greedy token fell outside the vocabulary")
    print(f"[encdec] {cfg.name}: decode step as one CUDA graph: steps 0-"
          f"{ENCDEC_EAGER_STEPS - 1} equal an eager run's logits bit for "
          f"bit; {steps} greedy steps from token {ENCDEC_SOT} in "
          f"{loop_s:.2f} s (host loop, a token read back a step), slot "
          f"0's first tokens {toks[0, :12].tolist()}", flush=True)
    # the cache is full: time the last step's replay
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ENCDEC_REPLAYS):
        unit.graph.replay()
    end.record()
    torch.cuda.synchronize()
    dev_ms = start.elapsed_time(end) / ENCDEC_REPLAYS
    with _device_profile() as prof:
        for _ in range(5):
            unit.graph.replay()
        torch.cuda.synchronize()
    by_name = _device_ms_by_kernel(prof, 5)
    kernels = len(_device_events(prof)) / 5
    bound, w, kv = _encdec_bytes_bound(cfg, params, cache, B,
                                       cache["k"].shape[2])
    top = "; ".join(f"{n[:56]} {ms:.3f}" for n, ms in by_name.most_common(6))
    print(f"[encdec] {cfg.name}: decode step (B={B}, self cache full at "
          f"{cache['k'].shape[2]}, cross {cache['xk'].shape[2]} rows) eager "
          f"{sorted(walls)[1]:.2f} wall ms, graph replay {dev_ms:.3f} device "
          f"ms against its bytes bound {bound:.3f} ms ({w / 1e9:.3f} GB of "
          f"weights + {kv / 1e9:.3f} GB of self and cross K/V over "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {dev_ms / bound:.2f}x), "
          f"{kernels:.0f} kernels a step; device ms by kind a step "
          f"(profiler): {_kernel_split(by_name, SSM_KERNEL_GROUPS, 1, SSM_OTHER)}"
          f"; top kernels (ms a step): {top}", flush=True)
    del unit, snap, eager
    return {"device_ms": dev_ms, "bound_ms": bound,
            "wall_ms": sorted(walls)[1], "kernels": kernels}


def _encdec_train(cfg) -> tuple:
    """14(d): api.loss_fn and its backward (float32 parameters, remat
    dots) on one make_batch batch (B=2, 1500 frames, 448 tokens): every
    B9 call held to its plain version, loss and gradient norm finite,
    the norm > 0; the launches of the checked step (the main path:
    counts from 0 around it) all on wgmma; B9's gradients at the
    encoder's and the cross-attention's shapes, on the step's own q, k,
    v, with the kernel forward against the plain forward (phase 10's
    bar); the model's gradients with the plain forward printed beside
    them; a timed step and its peak memory; then apply_ef(int8_ef) of
    the gradients on the card bit for bit the same call on the CPU."""
    import torch
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.tree import items_with_path, leaves, tree_map
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import api, attention
    from repro_torch.optim import compress
    from repro_torch.runtime.trainer import value_and_grad
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.float32)
    batch = api.make_batch(cfg, ShapeConfig(
        "train_30s", cfg.max_source_len, ENCDEC_TRAIN, "train"), 1,
        device=DEVICE)
    calls = 2 * (cfg.enc_layers + 2 * cfg.dec_layers)
    kfa.reset_launch_counts()
    with _CheckedFlash() as chk:
        loss, grads = value_and_grad(cfg, params, batch)
        torch.cuda.synchronize()
    launches = kfa.launch_counts()["flash_attention"]
    bodies = kfa.body_launches()
    _encdec_checked(chk, f"{cfg.name} loss_fn + backward (B={ENCDEC_TRAIN}, "
                    f"{cfg.max_source_len} frames, {cfg.max_target_len} "
                    f"tokens, remat {cfg.remat})", calls)
    if launches != calls or bodies["wgmma"] != calls:
        fail(f"{cfg.name} training step: B9 launched {launches} times "
             f"({bodies}), not {calls} on wgmma")
    gnorm = torch.sqrt(sum(g.float().square().sum() for g in leaves(grads)))
    if not (torch.isfinite(loss) and torch.isfinite(gnorm)
            and gnorm.item() > 0):
        fail(f"{cfg.name} training step: loss {loss.item()} or grad norm "
             f"{gnorm.item()} not finite and positive")
    # B9's own gradients at whisper's shapes (phase 10(b)'s check)
    worst = 0.0
    for (Sq, Sk, causal), (q, k, v, kw) in sorted(chk.first.items()):
        g = torch.Generator(device=DEVICE).manual_seed(Sq + Sk)
        do = torch.randn(q.shape, generator=g, device=DEVICE).to(q.dtype)
        xs = [x.clone().requires_grad_() for x in (q, k, v)]

        def grads_of():
            out = attention.flash_attention(*xs, causal=causal)
            return torch.autograd.grad(out, xs, do)

        got = grads_of()
        with _PlainForward():
            want = grads_of()
        rel = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
                  for a, b in zip(got, want))
        worst = max(worst, rel)
        print(f"[encdec] B9 grads on the step's q, k, v (Sq={Sq}, Sk={Sk}, "
              f"causal={causal}): max |kernel - plain| / max |plain| over "
              f"dq, dk, dv {rel:.3e} (limit {FLASH_GRAD_REL_LIMIT:.3e})",
              flush=True)
    if worst > FLASH_GRAD_REL_LIMIT:
        fail(f"{cfg.name}: B9 gradients with the kernel forward differ from "
             f"the plain forward's by {worst:.3e} of max |g|")
    with _PlainForward():
        ploss, pgrads = value_and_grad(cfg, tree_map(
            lambda t: t.detach(), params), batch)
    # per leaf; the key biases' exact gradient is 0 (a shift of one
    # query's scores), rounding noise on both sides: left out
    model_rel = max(
        (((a.float() - b.float()).abs().max()
          / b.float().abs().max()).item(), path)
        for (path, a), (_, b) in zip(items_with_path(grads),
                                     items_with_path(pgrads))
        if not path.endswith("attn/bk"))
    del pgrads
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    value_and_grad(cfg, tree_map(lambda t: t.detach(), params), batch)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    print(f"[encdec] {cfg.name} training step: loss {loss.item():.5f} "
          f"(plain forward {ploss.item():.5f}), grad norm "
          f"{gnorm.item():.4f}; the model's gradients with the plain "
          f"forward: worst leaf max |diff| / max |g| {model_rel[0]:.3e} "
          f"({model_rel[1]}; printed); loss + backward {step_ms:.1f} ms, peak memory "
          f"{peak / 1e9:.2f} GB; B9 launches {launches} by body {bodies}",
          flush=True)
    cg, ce = compress.apply_ef(grads, compress.make_ef_state(grads),
                               "int8_ef")
    cpu = tree_map(lambda t: t.cpu(), grads)
    hg, he = compress.apply_ef(cpu, compress.make_ef_state(cpu), "int8_ef")
    for name, a, b in (("gradients", cg, hg), ("error state", ce, he)):
        for (path, x), (_, y) in zip(items_with_path(a), items_with_path(b)):
            if not torch.equal(x.cpu(), y):
                fail(f"apply_ef int8_ef on the card: {name} {path} differs "
                     f"from the CPU's")
    print(f"[encdec] apply_ef(int8_ef) of the step's {len(leaves(grads))} "
          f"gradient leaves on the card equals the CPU's bit for bit "
          f"(compressed gradients and error state)", flush=True)
    del params, grads, cg, ce, cpu, hg, he
    return launches, bodies, {"step_ms": step_ms, "peak_gb": peak / 1e9}


def _encdec_small_run(cfg, params, frames, steps, device, dtype):
    """api.prefill, then `steps` greedy decode steps from token 0:
    [(logits on the CPU, token)] a step, each device feeding its own
    argmax."""
    import torch
    from repro_torch.models import api
    B = frames.shape[0]
    cache = api.init_cache(cfg, B, cfg.max_target_len, dtype, device=device)
    _, cache = api.prefill(cfg, params, {"frames": frames.to(device, dtype)},
                           cache)
    tok = torch.zeros(B, dtype=torch.int32, device=device)
    out = []
    for i in range(steps):
        lg, cache = api.decode_step(cfg, params, cache, tok, i)
        tok = lg.argmax(-1).to(torch.int32)
        out.append((lg.float().cpu(), tok.cpu()))
    return out


def _encdec_small() -> None:
    """14(e): the reduced whisper-small (float32 weights, bf16
    activations) on the card and on the CPU, the same frames: every
    greedy step's tokens equal until a step where the CPU's top-2 margin
    is within SMALL_MARGIN (nothing is held after it), the logits before
    it within max(SSM_SMALL_STEPS, SSM_NOISE x the CPU's own distance
    from its float32 run) bf16 steps (phase 13(c)'s rule)."""
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api
    cfg = reduced_config(ENCDEC_ARCH)
    B, S, steps = ENCDEC_SMALL_SHAPE
    cpu_params = api.init(cfg, 0, device="cpu")
    params = _tree_to(cpu_params, DEVICE)
    frames = api.make_batch(cfg, ShapeConfig("p", S, B, "prefill"), 7,
                            device="cpu")["frames"].float()
    card = _encdec_small_run(cfg, params, frames, steps, DEVICE,
                             torch.bfloat16)
    cpu = _encdec_small_run(cfg, cpu_params, frames, steps, "cpu",
                            torch.bfloat16)
    with _Float32Rows():
        f32 = _encdec_small_run(cfg, cpu_params, frames, 1, "cpu",
                                torch.float32)
    noise = _bf16_steps(f32[0][0], cpu[0][0])
    bar = max(SSM_SMALL_STEPS, SSM_NOISE * noise)
    worst, parted = 0.0, None
    for i, ((lc, tc), (lg, tg)) in enumerate(zip(cpu, card)):
        worst = max(worst, _bf16_steps(lc, lg))
        if not torch.equal(tc, tg):
            top2 = lc.topk(2, -1).values
            margin = (top2[:, 0] - top2[:, 1])[tc != tg].max().item()
            if margin > SMALL_MARGIN:
                fail(f"{cfg.name} card vs CPU: step {i} parts at a top-2 "
                     f"margin {margin:.4f} > {SMALL_MARGIN}")
            parted = (i, margin)
            break
    print(f"[encdec] (e) {cfg.name} card vs CPU, B={B}, {S} frames, {steps} "
          f"greedy steps: logits within {worst:.2f} bf16 steps of max "
          f"|logit| (limit {bar:.2f}: the CPU's bf16 run lies {noise:.2f} "
          f"steps from its float32 run), "
          + ("streams equal" if parted is None else
             f"parted at step {parted[0]} at a CPU top-2 margin "
             f"{parted[1]:.4f} (<= {SMALL_MARGIN})"), flush=True)
    if worst > bar:
        fail(f"{cfg.name} card vs CPU: logits {worst:.2f} bf16 steps apart "
             f"(limit {bar:.2f})")


def phase_encdec() -> dict:
    """Phase 14: full-width whisper-small (random bf16 weights, seed 0;
    B=8 random bf16 30-second windows of 1500 x 768 frames, make_batch's
    draw).  (a) B9 at whisper's encoder and cross-attention shapes runs
    in phase 10's FLASH_CASES (whisper-enc, whisper-cross).  (b)
    api.prefill with every B9 call held to its plain version, 12
    launches on wgmma; prefill ms and frames/s.  (c) the decode step as
    one CUDA graph, greedy to max_target_len, the first 16 steps equal
    an eager run's bit for bit; device ms against the bytes bound.  (d)
    loss_fn and its backward on a B=2 batch, every B9 call checked,
    B9's gradients at whisper's shapes kernel vs plain forward, apply_ef
    card vs CPU bit for bit.  (e) the reduced model card vs CPU.
    Returns B9's launches on the main paths (prefill, training) by
    path and by body."""
    import torch
    t_start = time.perf_counter()
    _free_card()
    cfg, params, frames = _encdec_model()
    torch.cuda.reset_peak_memory_stats()
    cache, pre_n, pre_bodies, prefill_ms = _encdec_prefill(cfg, params,
                                                           frames)
    dec = _encdec_decode(cfg, params, cache)
    peak = torch.cuda.max_memory_allocated()
    print(f"[encdec] {cfg.name} serving (B={ENCDEC_PREFILL}): peak memory "
          f"{peak / 1e9:.2f} GB; (b)-(c) in "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    del params, cache, frames
    _free_card()
    train_n, train_bodies, train = _encdec_train(cfg)
    _free_card()
    _encdec_small()
    bodies = {b: pre_bodies.get(b, 0) + train_bodies.get(b, 0)
              for b in set(pre_bodies) | set(train_bodies)}
    print(f"[encdec] phase 14 in {time.perf_counter() - t_start:.1f} s; "
          f"prefill {prefill_ms:.2f} ms, decode {dec['device_ms']:.3f} / "
          f"bound {dec['bound_ms']:.3f} ms, training step "
          f"{train['step_ms']:.1f} ms; flash_attention prefill {pre_n}, "
          f"training {train_n}, by body {bodies}", flush=True)
    return {"flash": pre_n + train_n,
            "flash_by_path": {"prefill": pre_n, "trainer": train_n},
            "flash_bodies": bodies, "prefill_ms": prefill_ms,
            "decode": dec, "train": train}


# ----------------------------------------------------------------------
# 16. the sharded training step on a (data, model) mesh
# ----------------------------------------------------------------------

SHARDED_MESH = (2, 4)                  # ("data", "model"), spread over the card
SHARDED_PLAN = "fsdp_tp"
SHARDED_TRAIN = (2, 4096)              # B, S of (a) and (b)
SHARDED_LAYERS = 2                     # (b)'s depth (4 to PR 30)
SHARDED_STEPS = 3
SHARDED_PLANS = ("dp", "fsdp", "tp", "fsdp_tp", "fsdp_tp_spact")
SHARDED_SMALL = ("yi-6b", "internvl2-1b")
SHARDED_SMALL_BATCH = (4, 32)
# (a)'s bars: the reference's own sharded-vs-one-device loss bar, and
# tests/test_torch_train.py's bf16 gradient rule (5% of each leaf's norm)
SHARDED_LOSS_ABS = 7e-3
SHARDED_GRAD_REL = 0.05
# (c)'s bars: test_trainer_matches_reference_trainer's bf16 bars
SHARDED_FIRST_ABS, SHARDED_ALL_ABS = 2e-3, 1e-2


def _sharded_setup():
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding.plans import get_plan
    return make_host_mesh(SHARDED_MESH, spread=DEVICE), get_plan(SHARDED_PLAN)


def _shard_flash_shape(cfg, B: int, S: int) -> tuple:
    """B9's shape a position on the mesh: [B/data, S, H/model, hd] over
    KH/model kv heads, on its bf16 body."""
    from repro_torch.kernels import flash_attention as kfa
    import torch
    data, model = SHARDED_MESH
    return (B // data, S, S, cfg.num_heads // model,
            cfg.num_kv_heads // model, cfg.head_dim,
            kfa.body(torch.bfloat16, cfg.head_dim))


def phase_sharded_layer() -> dict:
    """16(a): full-width yi-6b cut to 1 layer (remat dots, float32
    parameters, bf16 activations), B=2 x 4096: the fsdp_tp step's loss
    and gradients on the (2, 4) mesh against the one-device step's, on
    the same weights and batch; every B9 call of the sharded step held
    to its plain version, its launches (8 positions x forward + remat
    recompute) and the shapes the wrapper saw checked."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.models import api, convert
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.trainer import value_and_grad
    t0 = time.perf_counter()
    cfg = _train_config(get_config("yi-6b"), 1)
    B, S = SHARDED_TRAIN
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.float32)
    batch = {k: v.to(DEVICE) for k, v in next(
        SyntheticLMData(cfg.vocab_size, B, S).batches(0)).items()}
    mesh, plan = _sharded_setup()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    loss1, grads1 = value_and_grad(cfg, params, batch)
    norm1 = global_norm(grads1).item()
    torch.cuda.synchronize()
    one_s = time.perf_counter() - t1
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    del params
    _free_card()
    kfa.reset_launch_counts()
    with _CheckedFlash() as chk:
        t1 = time.perf_counter()
        loss, grads = value_and_grad(cfg, sharded, batch, mesh=mesh,
                                     plan=plan)
        norm = global_norm(grads).item()
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t1
    launches = kfa.launch_counts()["flash_attention"]
    bodies = kfa.body_launches()
    shapes = kfa.shape_launches()
    worst, worst_key = 0.0, ""
    from repro_torch.core.tree import items_with_path
    want = dict(items_with_path(grads1))
    for key, g in items_with_path(convert.gather_params(grads)):
        a = want[key]
        rel = (torch.linalg.norm(g - a) / torch.linalg.norm(a)).item()
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, key
    dloss = abs(loss.item() - loss1.item())
    shape = _shard_flash_shape(cfg, B, S)
    want_launches = 2 * cfg.num_layers * mesh.size
    print(f"[sharded] (a) yi-6b full width 1 layer, B={B} S={S}, remat "
          f"{cfg.remat}, {SHARDED_PLAN} on {SHARDED_MESH} spread over the "
          f"card: loss {loss.item():.5f} (one device {loss1.item():.5f}, "
          f"|diff| {dloss:.2e}, limit {SHARDED_LOSS_ABS:.0e}); grad_norm "
          f"{norm:.4f} (one device {norm1:.4f}); worst gradient leaf "
          f"{worst_key} at {worst:.3e} of its norm (limit "
          f"{SHARDED_GRAD_REL}); value_and_grad {sharded_s * 1e3:.1f} ms "
          f"sharded (first call), {one_s * 1e3:.1f} ms one device (first "
          f"call); B9 launches {launches} (want {want_launches}), by shape "
          f"{shapes}, each held to plain: max |kernel - plain| / max |o| = "
          f"{chk.worst:.3e}, lse {chk.lse:.3e}; phase "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if not (math.isfinite(loss.item()) and math.isfinite(norm)):
        fail("the sharded step gave a non-finite loss or gradient norm")
    if dloss > SHARDED_LOSS_ABS:
        fail(f"the sharded loss is {dloss} from the one-device loss")
    if not worst <= SHARDED_GRAD_REL:
        fail(f"sharded gradient {worst_key} is {worst} of its norm from "
             "the one-device gradient")
    if launches != want_launches or shapes != {shape: want_launches}:
        fail(f"B9 ran {launches} times at {shapes}, not {want_launches} "
             f"at the shards' shape {shape}")
    if chk.worst > FLASH_BF16_STEP or chk.lse > FLASH_F32_LIMIT:
        fail(f"a B9 call of the sharded step differs from its plain "
             f"version: o {chk.worst:.3e} of max |o|, lse {chk.lse:.3e}")
    del sharded, grads, grads1
    _free_card()
    return {"launches": launches, "bodies": bodies,
            "shapes": {str(k): v for k, v in shapes.items()}}


def _train_profile_split(prof) -> tuple:
    """(device ms, device ms by TRAIN_KERNEL_GROUPS kind) of one
    profiled training step."""
    by_name = _device_ms_by_kernel(prof, 1)
    groups = {g: 0.0 for g in TRAIN_KERNEL_GROUPS}
    for n, ms in by_name.items():
        g = next((g for g, keys in TRAIN_KERNEL_GROUPS.items()
                  if any(key in n for key in keys)), "other")
        groups[g] = groups.get(g, 0.0) + ms
    return sum(by_name.values()), groups


def _sharded_trainer_run(cfg, mesh, plan, steps: int,
                         profile: bool = False) -> dict:
    """`steps` of Trainer.run from the seed-0 start (fresh batches, no
    checkpoints), sharded when `mesh` is given; B9's count set to 0
    just before and read just after.  With `profile`, one more step
    under torch.profiler: its wall ms, device ms and device ms by
    kind."""
    import tempfile
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.runtime.trainer import Trainer
    B, S = SHARDED_TRAIN
    with tempfile.TemporaryDirectory() as td:
        tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1,
                           total_steps=100, ckpt_every=10 ** 6, ckpt_dir=td)
        kw = (dict(mesh=mesh, plan=plan) if mesh is not None
              else dict(device=DEVICE))
        tr = Trainer(cfg, tcfg, data=SyntheticLMData(cfg.vocab_size, B, S),
                     **kw)
        tr.init()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kfa.reset_launch_counts()
        hist = list(tr.run(steps))
        torch.cuda.synchronize()
        out = {"losses": [m.loss for m in hist],
               "step_ms": [m.step_time_s * 1e3 for m in hist],
               "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
               "flash": kfa.launch_counts()["flash_attention"],
               "bodies": kfa.body_launches(),
               "shapes": kfa.shape_launches()}
        if profile:
            t0 = time.perf_counter()
            with _device_profile() as prof:
                tr.run(1)
                torch.cuda.synchronize()
            out["profile"] = ((time.perf_counter() - t0) * 1e3,
                              *_train_profile_split(prof))
        del tr
    _free_card()
    steady = out["step_ms"][1:] or out["step_ms"]
    out["steady_ms"] = sum(steady) / len(steady)
    out["tokens_s"] = B * S / (out["steady_ms"] / 1e3)
    return out


def phase_sharded_trainer() -> dict:
    """16(b): full-width yi-6b cut to 2 layers (remat dots, B=2 x 4096):
    Trainer(mesh=, plan=fsdp_tp) for 3 steps, twice from the same start
    (the two loss streams equal bit for bit), then the one-device
    Trainer for 3 steps from the same start, each freed before the
    next.  Held: finite losses, the last below the first, B9 launched
    8 positions x 2 a layer a step at the shards' shape.  Printed, a
    record: step ms, tokens/s, peak memory, B9 launches beside the
    one-device run's, and both loss streams."""
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    cfg = _train_config(get_config("yi-6b"), SHARDED_LAYERS)
    mesh, plan = _sharded_setup()
    runs = [_sharded_trainer_run(cfg, mesh, plan, SHARDED_STEPS,
                                 profile=not i) for i in range(2)]
    one = _sharded_trainer_run(cfg, None, None, SHARDED_STEPS, profile=True)
    a, b = runs
    B, S = SHARDED_TRAIN
    for tag, r in (("sharded", a), ("sharded again", b), ("one device", one)):
        print(f"[sharded] (b) yi-6b full width {cfg.num_layers} layers "
              f"{tag}: losses {r['losses']}, step_ms "
              f"{[round(x, 1) for x in r['step_ms']]}, steady step_ms "
              f"{r['steady_ms']:.1f}, tokens/s {r['tokens_s']:.1f}, peak "
              f"memory {r['peak_gb']:.2f} GB, B9 launches {r['flash']} by "
              f"body {r['bodies']}", flush=True)
    for tag, r in (("sharded", a), ("one device", one)):
        wall, dev, groups = r["profile"]
        split = "; ".join(f"{g} {ms:.1f}" for g, ms in groups.items())
        print(f"[profile] (b) one {tag} Trainer.run step under the "
              f"profiler: wall {wall:.1f} ms; "
              + (f"device {dev:.1f} ms ({dev / wall:.0%} of the wall); "
                 f"device ms by kind: {split}" if dev else
                 "device time not measured (the profiler saw no kernel)"),
              flush=True)
    print(f"[sharded] (b) phase in {time.perf_counter() - t0:.1f} s",
          flush=True)
    want = 2 * cfg.num_layers * mesh.size * SHARDED_STEPS
    shape = _shard_flash_shape(cfg, B, S)
    for r in (a, b):
        if not all(math.isfinite(x) for x in r["losses"]):
            fail(f"the sharded Trainer gave non-finite losses {r['losses']}")
        if not r["losses"][-1] < r["losses"][0]:
            fail(f"the sharded Trainer's losses did not fall: {r['losses']}")
        if r["flash"] != want or r["shapes"] != {shape: want}:
            fail(f"the sharded Trainer ran B9 {r['flash']} times at "
                 f"{r['shapes']}, not {want} at {shape}")
    if a["losses"] != b["losses"]:
        fail(f"two sharded runs from one start differ: {a['losses']} vs "
             f"{b['losses']}")
    return {"launches": a["flash"] + b["flash"],
            "bodies": {k: a["bodies"][k] + b["bodies"][k]
                       for k in a["bodies"]},
            "sharded": a, "one_device": one}


def phase_sharded_small() -> None:
    """16(c): reduced yi-6b and reduced internvl2-1b (prefix_embeds, 4 q
    heads over 2 kv heads: replicated over `model`), every plan on the
    (2, 4) card mesh for 3 Trainer steps against the same run on a
    (2, 4) mesh spread over the CPU from the same start:
    test_trainer_matches_reference_trainer's bf16 bars."""
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.sharding.plans import get_plan
    t0 = time.perf_counter()
    B, S = SHARDED_SMALL_BATCH
    worst = 0.0
    for arch in SHARDED_SMALL:
        cfg = reduced_config(arch)
        extra = ({"prefix_embeds": ((cfg.num_prefix_tokens, cfg.d_model),
                                    np.float32)}
                 if cfg.family == "vlm" else None)
        start = api.init(cfg, 0, device="cpu")
        for name in SHARDED_PLANS:
            losses = {}
            for dev in (DEVICE, "cpu"):
                with tempfile.TemporaryDirectory() as td:
                    tcfg = TrainConfig(total_steps=50, warmup_steps=2,
                                       ckpt_every=100, ckpt_dir=td,
                                       learning_rate=1e-3)
                    tr = Trainer(cfg, tcfg,
                                 data=SyntheticLMData(cfg.vocab_size, B, S,
                                                      extra=extra),
                                 mesh=make_host_mesh(SHARDED_MESH,
                                                     spread=dev),
                                 plan=get_plan(name))
                    tr.set_params(_tree_to(start, torch.device(dev)))
                    losses[dev] = [m.loss for m in tr.run(SHARDED_STEPS)]
            card, cpu = losses[DEVICE], losses["cpu"]
            d0 = abs(card[0] - cpu[0])
            dall = max(abs(x - y) for x, y in zip(card, cpu))
            worst = max(worst, dall)
            print(f"[sharded] (c) reduced {arch} {name}: card {card} vs CPU "
                  f"{cpu}: first |diff| {d0:.2e} (limit "
                  f"{SHARDED_FIRST_ABS:.0e}), all {dall:.2e} (limit "
                  f"{SHARDED_ALL_ABS:.0e})", flush=True)
            if not (d0 <= SHARDED_FIRST_ABS and dall <= SHARDED_ALL_ABS):
                fail(f"reduced {arch} under {name}: the card's sharded run "
                     f"parts from the CPU's: {card} vs {cpu}")
    print(f"[sharded] (c) phase in {time.perf_counter() - t0:.1f} s; worst "
          f"|card - CPU| loss {worst:.2e}", flush=True)


def phase_sharded() -> dict:
    """Phase 16, all of it.  Returns B9's launches on its main paths
    ((a)'s checked step and (b)'s sharded Trainer runs) and by body."""
    t0 = time.perf_counter()
    a = phase_sharded_layer()
    b = phase_sharded_trainer()
    phase_sharded_small()
    print(f"[sharded] phase 16 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"flash": a["launches"] + b["launches"],
            "flash_bodies": {k: v + a["bodies"][k]
                             for k, v in b["bodies"].items()},
            "shapes": a["shapes"], "trainer": b}


# ----------------------------------------------------------------------
# 17. the other families' sharded training step on the (data, model) mesh
# ----------------------------------------------------------------------

# (a)'s cells: each family at full width cut to one layer (a block; the
# stack's depth makes random full-width runs chaotic), fsdp_tp on
# phase 16's (2, 4) mesh spread over the card, B=2 (a row a data
# position), S=2048 (whisper-small: 448 tokens against 1500 frames)
SHARDED_FAMILIES = (
    ("moonshot-v1-16b-a3b", {"num_layers": 1}),
    ("falcon-mamba-7b", {"num_layers": 1}),
    ("zamba2-2.7b", {"num_layers": 1, "attn_every": 1}),
    ("whisper-small", {"num_layers": 2, "enc_layers": 1, "dec_layers": 1}),
)
SHARDED_FAMILY_TRAIN = (2, 2048)
# (a)'s loss bar where the reference's own sharded / one-device distance
# at the reduced size is the larger: 1.5 x the bf16 distance its
# fsdp_tp and one-device steps read for reduced zamba2-2.7b
# (tests/test_torch_sharded_hybrid.py's reference children)
SHARDED_FAMILY_LOSS = {"zamba2-2.7b": 1.5 * 1.92e-2}
# (a)'s bf16 gradient bar where the reference's own sharded / one-device
# distance is the larger: 1.5 x the smallest distance any leaf of its
# reduced zamba2-2.7b reads, bf16 as it runs (6.97%, final_norm's scale;
# conv_b 81%: tests/test_torch_sharded_hybrid.py::
# test_the_references_own_distances); (a)'s float32 step holds every
# leaf far tighter
SHARDED_FAMILY_GRAD = {"zamba2-2.7b": 1.5 * 0.0697}
# (a)'s float32 step (float32 rows and frames), sharded against one
# device: the loss within SHARDED_F32_LOSS relative; every gathered
# gradient leaf within SHARDED_F32_GRAD of its max |g| (the CPU tests'
# bar) or SHARDED_F32_FLOOR x the family's rounding floor, where that is
# the larger.  The floor is the furthest any leaf of the one-device
# gradient moves, against its max |g|, when every weight moves by about
# one float32 rounding (x (1 + 2^-23 N(0, 1))): a full-width random
# layer amplifies roundings (zamba2 2.1e-4, whisper 1.0e-3; reduced, on
# the CPU, 1e-5 and less), and the sharded step rounds at other places.
# A moe's float32 steps take the one-device step's expert ids, so that a
# near tie the sharding breaks the other way (a token's rows move
# whole to another expert) is printed and held as in bf16, not compared
# as a gradient.
SHARDED_F32_LOSS, SHARDED_F32_GRAD, SHARDED_F32_FLOOR = 1e-5, 1e-4, 3.0
# (b)'s float32-rows runs, card mesh against CPU mesh: all 3 losses
# within this, about 3x the largest reading (AdamW's normalized steps
# grow float32 roundings: the chaotic reduced zamba2 read 1.69e-4 at
# its third step, moonshot 9.5e-7)
SHARDED_F32_ALL = 5e-4
# moonshot's expert ids, card sharded against card one device: they may
# part where a router logit tie is broken by a rounding (each position's
# router columns are a product of another width), at most this share
SHARDED_IDS_PARTED = 0.01
# (b)'s runs, card mesh against CPU mesh: arch, plan, microbatches
SHARDED_FAMILY_SMALL = (
    ("moonshot-v1-16b-a3b", "fsdp_tp", 1),
    ("moonshot-v1-16b-a3b", "tp", 2),
    ("falcon-mamba-7b", "fsdp_tp", 1),
    ("zamba2-2.7b", "fsdp_tp", 1),
    ("whisper-small", "fsdp_tp", 1),
)


def _family_train_batch(cfg, B: int, S: int) -> dict:
    """SyntheticLMData's batch 0 on the card (encdec: max_target_len
    tokens and standard-normal bf16 frames, seed 1)."""
    import torch
    from repro_torch.data.pipeline import SyntheticLMData
    if cfg.family == "encdec":
        S = cfg.max_target_len
    batch = {k: v.to(DEVICE) for k, v in next(
        SyntheticLMData(cfg.vocab_size, B, S).batches(0)).items()}
    if cfg.family == "encdec":
        g = torch.Generator(device=DEVICE).manual_seed(1)
        batch["frames"] = torch.randn(
            (B, cfg.max_source_len, cfg.d_model), generator=g,
            device=DEVICE).to(torch.bfloat16)
    return batch


def _family_flash_shapes(cfg, B: int, S: int) -> dict:
    """B9's launches by shape key (kernels.flash_attention.
    shape_launches) in one sharded step: 8 positions x (forward + remat
    recompute) a call site, each at [B/data, Sq, H/model, hd] over
    Sk keys and KH/model kv heads."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    data, model = SHARDED_MESH
    n = 2 * data * model
    if cfg.family == "ssm":
        return {}
    hd = cfg.head_dim
    b, H, KH = B // data, cfg.num_heads // model, cfg.num_kv_heads // model
    body = kfa.body(torch.bfloat16, hd)
    if cfg.family != "encdec":
        sites = cfg.num_layers // (cfg.attn_every if cfg.family == "hybrid"
                                   else 1)
        return {(b, S, S, H, KH, hd, body): n * sites}
    Se, Sd = cfg.max_source_len, cfg.max_target_len
    out = {(b, Se, Se, H, KH, hd, body): n * cfg.enc_layers,
           (b, Sd, Sd, H, KH, hd, body): n * cfg.dec_layers}
    key = (b, Sd, Se, H, KH, hd, body)
    out[key] = out.get(key, 0) + n * cfg.dec_layers
    return out


class _DispatchSpy:
    """Within the block, the first `moe.dispatch` of a run: its expert
    ids, drop mask and logits."""

    def __enter__(self):
        from repro_torch.models import moe
        self.moe, self.orig, self.first = moe, moe.dispatch, None

        def spy(cfg, logits):
            r = self.orig(cfg, logits)
            if self.first is None:
                self.first = (r.idx.clone(), r.keep.clone(),
                              logits.detach().clone())
            return r

        moe.dispatch = spy
        return self

    def __exit__(self, *exc):
        self.moe.dispatch = self.orig


def _family_step(cfg, params, batch, mesh=None, plan=None) -> dict:
    """value_and_grad twice: the first with every B9 call held to its
    plain version (`_CheckedFlash`), B9's counts from 0 around it, the
    first moe dispatch recorded; the second timed alone.  Returns the
    loss, the gradients, their norm, the step ms, peak memory and the
    launches."""
    import torch
    from repro_torch.kernels import flash_attention as kfa
    from repro_torch.optim.adamw import global_norm
    from repro_torch.runtime.trainer import value_and_grad
    kw = dict(mesh=mesh, plan=plan)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kfa.reset_launch_counts()
    with _CheckedFlash() as chk, _DispatchSpy() as spy:
        loss, grads = value_and_grad(cfg, params, batch, **kw)
        torch.cuda.synchronize()
    out = {"launches": kfa.launch_counts()["flash_attention"],
           "bodies": kfa.body_launches(), "shapes": kfa.shape_launches(),
           "chk": chk, "route": spy.first, "loss": loss.item(),
           "norm": global_norm(grads).item()}
    del grads
    t0 = time.perf_counter()
    loss, grads = value_and_grad(cfg, params, batch, **kw)
    torch.cuda.synchronize()
    out["ms"] = (time.perf_counter() - t0) * 1e3
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["grads"] = grads
    return out


class _F32Rows:
    """Within the block every embedding keeps float32 rows (the models'
    `embed_tokens`, as the CPU tests patch them), so a step whose other
    inputs are float32 runs in float32."""

    def __enter__(self):
        import torch.nn.functional as F
        from repro_torch.models import encdec, hybrid, ssm_lm, transformer
        self.mods = (transformer, ssm_lm, hybrid, encdec)
        self.saved = [m.embed_tokens for m in self.mods]
        for m in self.mods:
            m.embed_tokens = (lambda cfg, params, tokens, prefix_embeds=None:
                              F.embedding(tokens.long(), params["embed"]))
        return self

    def __exit__(self, *exc):
        for m, f in zip(self.mods, self.saved):
            m.embed_tokens = f


def _family_f32_step(cfg, params, batch, mesh=None, plan=None) -> tuple:
    """(loss, gradients by key, gathered) of the step with float32
    activations (`_F32Rows`, float32 frames)."""
    import torch
    from repro_torch.core.tree import items_with_path
    from repro_torch.models import convert
    from repro_torch.runtime.trainer import value_and_grad
    with _F32Rows():
        b32 = {k: v.float() if v.is_floating_point() else v
               for k, v in batch.items()}
        loss, grads = value_and_grad(cfg, params, b32, mesh=mesh, plan=plan)
    torch.cuda.synchronize()
    if mesh is not None:
        grads = convert.gather_params(grads)
    return loss.item(), dict(items_with_path(grads))


class _ForcedRoute:
    """Within the block the first moe router call takes the expert ids
    `idx` [T, k] (its gates: their probabilities, renormalized; its aux
    from their first column), and records the ids it would have taken
    and its logits (`natural`)."""

    def __init__(self, idx):
        self.idx, self.natural = idx, None

    def __enter__(self):
        import torch
        import torch.nn.functional as F
        from repro_torch.models import moe
        self.moe, self.orig = moe, moe.route_logits

        def forced(cfg, logits):
            _, natural, _ = self.orig(cfg, logits)
            if self.natural is None:
                self.natural = (natural.clone(), logits.detach().clone())
            probs = torch.softmax(logits, dim=-1)
            idx = self.idx.to(logits.device)
            gates = probs.gather(1, idx)
            gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
            E = cfg.num_experts
            aux = E * torch.sum(probs.mean(0)
                                * F.one_hot(idx[:, 0], E).float().mean(0))
            return gates, idx, aux

        moe.route_logits = forced
        return self

    def __exit__(self, *exc):
        self.moe.route_logits = self.orig


def _parted(i1, i2, logits, step: float) -> tuple:
    """(assignments whose expert ids part between `i1` and `i2` [T, k],
    the parted experts' widest logit gap in `step`s of each row's max
    |logit|)."""
    parted = int((i1 != i2).sum().item())
    gaps = 0.0
    for t in (i1 != i2).any(-1).nonzero().flatten().tolist():
        at = i1[t] != i2[t]              # a set or an order parted
        vals = logits[t, sorted(set(i1[t][at].tolist())
                                | set(i2[t][at].tolist()))]
        gaps = max(gaps, ((vals.max() - vals.min())
                          / (step * logits[t].abs().max())).item())
    return parted, gaps


def _scale_key(key: str) -> str:
    """The leaf a gradient is scaled by: itself, but a key bias's query
    bias (its exact gradient is 0: a shift of every key's score by q.bk
    leaves the softmax as it is)."""
    return key[:-2] + "bq" if key.endswith("/bk") else key


def _family_sharded_layer(arch: str, cut: dict) -> dict:
    """17(a) for one family: the full-width config cut to one layer
    (float32 parameters, remat dots), the fsdp_tp step on the (2, 4)
    mesh against the one-device step on the same weights and batch.
    As it runs (bf16 activations): the loss within 7e-3 and every
    gathered gradient leaf within 5% in L2 norm (or 1.5 x the
    reference's own distance, SHARDED_FAMILY_LOSS / _GRAD), B9's launches and shapes (8 positions x forward +
    recompute a call site; one device 1 position) with every call
    within a bf16 step of its plain version; moonshot's expert ids and
    drops, sharded against one device, printed (parted ids at most
    SHARDED_IDS_PARTED of the assignments, each a near tie).  With
    float32 activations (float32 rows and frames): the loss within
    SHARDED_F32_LOSS relative and every gathered gradient leaf within
    SHARDED_F32_GRAD of its max |g| (a key bias's: of its query bias's)
    or SHARDED_F32_FLOOR x the rounding floor (the one-device step with
    its weights moved by about one float32 rounding); a moe's float32
    steps take the one-device step's expert ids, its own printed."""
    import contextlib
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.tree import items_with_path, tree_map
    from repro_torch.models import api, convert
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch), remat="dots", **cut)
    B, S = SHARDED_FAMILY_TRAIN
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.float32)
    batch = _family_train_batch(cfg, B, S)
    mesh, plan = _sharded_setup()
    secs = {"init": time.perf_counter() - t0}
    t1 = time.perf_counter()
    one = _family_step(cfg, params, batch)
    secs["one device"] = time.perf_counter() - t1
    want = {k: v for k, v in items_with_path(one.pop("grads"))}
    t1 = time.perf_counter()
    moe = cfg.family == "moe"
    with _DispatchSpy() as spy:
        loss32, want32 = _family_f32_step(cfg, params, batch)
    ids = spy.first[0] if moe else None
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    moved = tree_map(lambda t: t * (1 + 2.0 ** -23 * torch.randn(
        t.shape, generator=gen, device=t.device)), params)
    with (_ForcedRoute(ids) if moe else contextlib.nullcontext()):
        _, grads = _family_f32_step(cfg, moved, batch)
    del moved
    floor = max(((grads[k] - want32[k]).abs().max()
                 / want32[_scale_key(k)].abs().max()).item() for k in grads)
    del grads
    secs["one device float32"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    sharded = convert.shard_params(params, cfg, mesh,
                                   rules=plan.param_rules)
    del params
    _free_card()
    got = _family_step(cfg, sharded, batch, mesh, plan)
    secs["sharded"] = time.perf_counter() - t1
    full = dict(items_with_path(convert.gather_params(got.pop("grads"))))
    gbar = max(SHARDED_GRAD_REL, SHARDED_FAMILY_GRAD.get(arch, 0.0))
    worst, worst_key, over = 0.0, "", []
    for key, g in full.items():
        rel = (torch.linalg.norm(g - want[key])
               / torch.linalg.norm(want[_scale_key(key)])).item()
        if not rel <= gbar:
            over.append(key)
        if not math.isfinite(rel) or rel > worst:
            worst, worst_key = rel, key
    del full, want
    _free_card()
    t1 = time.perf_counter()
    with (_ForcedRoute(ids) if moe else contextlib.nullcontext()) as fr:
        got32, full32 = _family_f32_step(cfg, sharded, batch, mesh, plan)
    secs["sharded float32"] = time.perf_counter() - t1
    bar32 = max(SHARDED_F32_GRAD, SHARDED_F32_FLOOR * floor)
    worst32, worst32_key, over32 = 0.0, "", []
    for key, g in full32.items():
        rel = ((g - want32[key]).abs().max()
               / want32[_scale_key(key)].abs().max()).item()
        if not rel <= bar32:
            over32.append(key)
        if not math.isfinite(rel) or rel > worst32:
            worst32, worst32_key = rel, key
    dloss32 = abs(got32 - loss32) / abs(loss32)
    del full32, want32, sharded
    _free_card()
    dloss = abs(got["loss"] - one["loss"])
    bar = max(SHARDED_LOSS_ABS, SHARDED_FAMILY_LOSS.get(arch, 0.0))
    shapes = _family_flash_shapes(cfg, B, S)
    n_want = sum(shapes.values())
    route = ""
    parted = parted32 = 0
    if moe:
        (i1, k1, l1), (i2, k2, _) = one["route"], got["route"]
        parted, gaps = _parted(i1, i2, l1, 2.0 ** -7)
        parted32, gaps32 = _parted(ids, fr.natural[0], fr.natural[1],
                                   2.0 ** -23)
        route = (f"; expert ids: {parted} of {i1.numel()} assignments "
                 f"parted (sharded vs one device on the card; the parted "
                 f"experts' one-device logits within {gaps:.2f} bf16 "
                 f"steps), drops {int((~k2).sum())} sharded vs "
                 f"{int((~k1).sum())} one device; float32: {parted32} "
                 f"parted, within {gaps32:.2f} float32 steps (the "
                 f"float32 steps take the one-device ids)")
    chk = got["chk"]
    print(f"[sharded] 17(a) {arch} full width, {cut}, B={B} "
          + (f"S={S}" if cfg.family != "encdec" else
             f"{cfg.max_target_len} tokens x {cfg.max_source_len} frames")
          + f", "
          f"fsdp_tp on {SHARDED_MESH}: loss {got['loss']:.5f} (one device "
          f"{one['loss']:.5f}, |diff| {dloss:.2e}, limit {bar:.1e}); "
          f"grad_norm {got['norm']:.4f} (one device {one['norm']:.4f}); "
          f"worst gradient leaf {worst_key} at {worst:.3e} of its norm "
          f"(limit {gbar:.3g}); float32: loss {got32:.6f} (one device {loss32:.6f}, "
          f"{dloss32:.2e} relative, limit {SHARDED_F32_LOSS:.0e}), worst "
          f"gradient leaf {worst32_key} at {worst32:.3e} of its max |g| "
          f"(limit {bar32:.3e}: {SHARDED_F32_GRAD:.0e} or "
          f"{SHARDED_F32_FLOOR} x the rounding floor {floor:.3e}); "
          f"step {got['ms']:.1f} ms sharded vs "
          f"{one['ms']:.1f} ms one device (second call); peak memory "
          f"{got['peak_gb']:.2f} vs {one['peak_gb']:.2f} GB; B9 launches "
          f"{got['launches']} (want {n_want}) by shape {got['shapes']}, "
          f"each held to plain: o {chk.worst:.3e}, lse {chk.lse:.3e}; one "
          f"device {one['launches']} launches (want "
          f"{n_want // math.prod(SHARDED_MESH)}){route}; "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()) + ")",
          flush=True)
    if not all(math.isfinite(x) for x in (got["loss"], got["norm"])):
        fail(f"{arch}: the sharded step gave a non-finite loss or norm")
    if dloss > bar:
        fail(f"{arch}: the sharded loss is {dloss} from the one-device loss")
    if over:
        fail(f"{arch}: sharded gradients {over} lie further from the "
             "one-device gradients than their bars")
    if not dloss32 <= SHARDED_F32_LOSS or over32:
        fail(f"{arch}: with float32 activations the sharded loss lies "
             f"{dloss32:.2e} from the one-device loss, gradients {over32} "
             f"further than their bars")
    if got["launches"] != n_want or got["shapes"] != shapes:
        fail(f"{arch}: B9 ran {got['launches']} times at {got['shapes']}, "
             f"not at {shapes}")
    if one["launches"] != n_want // math.prod(SHARDED_MESH):
        fail(f"{arch}: the one-device step ran B9 {one['launches']} times, "
             f"not {n_want // math.prod(SHARDED_MESH)}")
    for c in (chk, one["chk"]):
        if c.worst > FLASH_BF16_STEP or c.lse > FLASH_F32_LIMIT:
            fail(f"{arch}: a B9 call differs from its plain version: o "
                 f"{c.worst:.3e} of max |o|, lse {c.lse:.3e}")
    if moe and max(parted, parted32) > SHARDED_IDS_PARTED * i1.numel():
        fail(f"{arch}: {parted} (bf16) and {parted32} (float32) expert "
             "ids part between the sharded and the one-device step")
    return {"launches": got["launches"], "bodies": got["bodies"],
            "shapes": {str(k): v for k, v in got["shapes"].items()},
            "ms": got["ms"], "one_ms": one["ms"]}


def _reduced_card_vs_cpu(arch: str, plan_name: str,
                         n_micro: int = 1) -> float:
    """3 steps of reduced `arch` on the (2, 4) card mesh against the same
    on a (2, 4) CPU mesh, from the same start and batches, as it runs
    (bf16) and with float32 rows (`_F32Rows`; the reduced whisper's
    frames are float32 either way): Trainer.run, or with microbatches
    the step Trainer would take (launch/train.make_train_step(n_micro=):
    Trainer has no microbatch option, in the reference either).  Held:
    bf16, phase 16(c)'s bars, the first loss within 2e-3 and all within
    1e-2, the later steps printed instead where either host's own bf16
    run lies further than 1e-2 from its float32 run (a moe's routing
    ties and the chaotic reduced zamba2, grown by AdamW's normalized
    steps: the bf16 trajectory is then rounding); float32 rows, always,
    the first loss within 1e-5 relative and all within SHARDED_F32_ALL.
    Returns the worst bf16 |card - CPU| loss."""
    import contextlib
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import SyntheticLMData
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import api
    from repro_torch.runtime.trainer import Trainer
    from repro_torch.sharding.plans import get_plan
    cfg = reduced_config(arch)
    B, S = SHARDED_SMALL_BATCH
    extra = None
    if cfg.family == "vlm":
        extra = {"prefix_embeds": ((cfg.num_prefix_tokens, cfg.d_model),
                                   np.float32)}
    if cfg.family == "encdec":
        S = cfg.max_target_len
        extra = {"frames": ((cfg.max_source_len, cfg.d_model), np.float32)}
    start = api.init(cfg, 0, device="cpu")
    losses = {}
    for rows in ("bf16", "f32"):
        for dev in (DEVICE, "cpu"):
            mesh = make_host_mesh(SHARDED_MESH, spread=dev)
            plan = get_plan(plan_name)
            data = SyntheticLMData(cfg.vocab_size, B, S, extra=extra)
            rounding = (_F32Rows() if rows == "f32"
                        else contextlib.nullcontext())
            with tempfile.TemporaryDirectory() as td, rounding:
                tcfg = TrainConfig(total_steps=50, warmup_steps=2,
                                   ckpt_every=100, ckpt_dir=td,
                                   learning_rate=1e-3)
                tr = Trainer(cfg, tcfg, data=data, mesh=mesh, plan=plan)
                tr.set_params(_tree_to(start, torch.device(dev)))
                if n_micro == 1:
                    run = [m.loss for m in tr.run(SHARDED_STEPS)]
                else:
                    step = launch_train.make_train_step(
                        cfg, tr.opt, n_micro=n_micro, mesh=mesh, plan=plan)
                    params, state, it, run = (tr.params, tr.opt_state,
                                              data.batches(0), [])
                    for _ in range(SHARDED_STEPS):
                        params, state, metrics = step(params, state,
                                                      next(it))
                        run.append(metrics["loss"].item())
            losses[rows, dev] = run

    def apart(a, b):
        return max(abs(x - y) for x, y in zip(a, b))

    card, cpu = losses["bf16", DEVICE], losses["bf16", "cpu"]
    card32, cpu32 = losses["f32", DEVICE], losses["f32", "cpu"]
    d0, dall = abs(card[0] - cpu[0]), apart(card, cpu)
    noise = max(apart(card, card32), apart(cpu, cpu32))
    held = noise <= SHARDED_ALL_ABS
    d32 = abs(card32[0] - cpu32[0]) / abs(cpu32[0])
    dall32 = apart(card32, cpu32)
    tag = f"{plan_name}" + (f", n_micro={n_micro}" if n_micro > 1 else "")
    print(f"[sharded] (b) reduced {arch} {tag}: bf16 card {card} vs CPU "
          f"{cpu}: first |diff| {d0:.2e} (limit {SHARDED_FIRST_ABS:.0e}), "
          f"all {dall:.2e} ("
          + (f"limit {SHARDED_ALL_ABS:.0e}" if held else "printed")
          + f": each host's bf16 run lies at most {noise:.2e} from its "
          f"float32 run); float32 rows card {card32} vs CPU {cpu32}: first "
          f"{d32:.2e} relative (limit 1e-5), all {dall32:.2e} (limit "
          f"{SHARDED_F32_ALL:.0e})", flush=True)
    if not (d0 <= SHARDED_FIRST_ABS and (dall <= SHARDED_ALL_ABS or not held)
            and d32 <= 1e-5 and dall32 <= SHARDED_F32_ALL):
        fail(f"reduced {arch} under {tag}: the card's sharded run parts "
             f"from the CPU's: bf16 {card} vs {cpu}, float32 rows {card32} "
             f"vs {cpu32}")
    return dall


def phase_sharded_families() -> dict:
    """Phase 17: (a) each family's full-width one-layer fsdp_tp step on
    the (2, 4) card mesh against one device (`_family_sharded_layer`);
    (b) the reduced families card mesh against CPU mesh
    (SHARDED_FAMILY_SMALL).  Returns B9's launches on the main path
    ((a)'s checked sharded steps), by body and by family."""
    t0 = time.perf_counter()
    launches, bodies, by_family = 0, {}, {}
    for arch, cut in SHARDED_FAMILIES:
        r = _family_sharded_layer(arch, cut)
        launches += r["launches"]
        for k, v in r["bodies"].items():
            bodies[k] = bodies.get(k, 0) + v
        by_family[arch] = r
    t1 = time.perf_counter()
    worst = max(_reduced_card_vs_cpu(*run) for run in SHARDED_FAMILY_SMALL)
    print(f"[sharded] 17(a) in {t1 - t0:.1f} s, (b) in "
          f"{time.perf_counter() - t1:.1f} s (worst |card - CPU| loss "
          f"{worst:.2e}); phase 17 in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return {"flash": launches, "flash_bodies": bodies,
            "by_family": by_family}


def main() -> None:
    t_start = time.perf_counter()
    device = phase_card()
    import dataclasses
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import api
    from repro_torch.te import linear as te_linear
    phase_build()
    phase_analysis()
    kernels = phase_kernels()
    phase_verify_kernels(kernels)
    phase_long_kernels(kernels)
    cfg = dataclasses.replace(get_config("yi-6b"), num_layers=SERVE_LAYERS)
    t0 = time.perf_counter()
    params = api.init(cfg, 0, device=DEVICE, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    print(f"[init] yi-6b full width, {cfg.num_layers} of "
          f"{get_config('yi-6b').num_layers} layers, "
          f"{cfg.param_count() / 1e9:.2f} B params in bf16, "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_forward(cfg, params)
    launches, by_body, units, kv_bytes, sharegpt = phase_serve(cfg, params)
    phase_contiguous(cfg, params, sharegpt)
    del sharegpt
    phase_slot(cfg, params)
    online = {"bf16": phase_online(cfg, params)}
    spec = {"bf16": phase_spec(cfg, params)}
    phase_profile(cfg, params)
    t0 = time.perf_counter()
    quant = te_linear.quantize_serving_params(params)
    torch.cuda.synchronize()
    print(f"[init] yi-6b layer weights quantized to e4m3 in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    phase_forward(cfg, params, quant)
    del quant
    phase_profile(cfg, params, fp8=True)
    fp8_launches, fp8_by_body, fp8_units, fp8_kv_bytes, _ = phase_serve(
        cfg, params, fp8=True)
    spec["fp8"] = phase_spec(cfg, params, fp8=True)
    online["fp8"] = phase_online(cfg, params, fp8=True)
    launches.update({k: v for k, v in fp8_launches.items()
                     if k.endswith("_fp8")})
    by_body.update({k: v for k, v in fp8_by_body.items()
                    if k.endswith("_fp8")})
    ratio = fp8_kv_bytes / kv_bytes
    want = (cfg.head_dim + 4) / (2 * cfg.head_dim)
    print(f"[serve] fp8 / bf16 KV pool bytes = {ratio} (expected {want})",
          flush=True)
    if ratio != want:
        fail(f"fp8 KV pool is {ratio} of the bf16 pool, not {want}")
    tp = phase_tp(cfg, params)
    del params
    phase_small(fp8=False)
    phase_small(fp8=True)
    mm_results, mm_launches, mm_bodies = phase_matmul()
    dd_results, dd_launches, dd_bodies = phase_dpx_dsm()
    flash_results, flash_launches, flash_bodies = phase_training()
    sharded = phase_sharded()
    families_sharded = phase_sharded_families()
    mem_results, mem_launches, te_flash, te_bodies = phase_memory_te()
    fam = phase_families()
    ssm = phase_ssm_families()
    ed = phase_encdec()
    line = []
    for name, line_no in (("paged_decode", 163), ("paged_chunk", 252),
                          ("paged_decode_fp8", 147),
                          ("paged_chunk_fp8", 234)):
        r = kernels[(name, "yi-6b", "bfloat16")]
        tag = "fp8" if name.endswith("fp8") else "bf16"
        served = fp8_units if tag == "fp8" else units
        # the serve waves' launches plus the online phase's, by work
        # unit as measured around each dispatch
        on = online[tag]
        launches[name] += on["launches"][name]
        by_body[name] = {b: n + on["by_body"][name].get(b, 0)
                         for b, n in by_body[name].items()}
        extra = {"launches_by_unit": {
            "span": served["span"][name] + on["by_unit"]["span"].get(name,
                                                                     0)}}
        if name.startswith("paged_chunk"):
            # the spec waves' too, and the verify shape
            sp = spec[tag]
            extra["launches_by_unit"] = {
                "chunk": (served["chunk"][name] + sp["by_unit"]["chunk"]
                          + on["by_unit"]["chunk"].get(name, 0)),
                "verify": sp["by_unit"]["verify"]}
            launches[name] += sp["launches"][name]
            by_body[name] = {b: n + sp["by_body"].get(b, 0)
                             for b, n in by_body[name].items()}
            v = kernels[(name, VERIFY_CASE[0], "bfloat16")]
            extra["verify_shape"] = {k: v[k] for k in (
                "max_abs_err", "ms", "device_ms", "bound_ms",
                "library_ms", "library_device_ms")}
        # phase 12's serve, spec and profile-free waves (moe and vlm)
        launches[name] += fam["paged"][name]
        by_body[name] = {b: n + fam["paged_bodies"][name].get(b, 0)
                         for b, n in by_body[name].items()}
        extra["launches_families"] = fam["paged"][name]
        # phase 15's tensor-parallel waves (tp x L a step, both shards)
        launches[name] += tp["launches"][name]
        by_body[name] = {b: n + tp["by_body"][name].get(b, 0)
                         for b, n in by_body[name].items()}
        extra["launches_tp"] = tp["launches"][name]
        extra["tp_shard_shapes"] = {
            f"{case} {dname}": {k: v[k] for k in (
                "max_abs_err", "ms", "device_ms", "bound_ms",
                "library_ms", "library_device_ms")}
            for (kern, case, dname), v in kernels.items()
            if kern == name and "shard" in case}
        extra["long_context"] = {
            f"{case} {dname}": {k: v[k] for k in (
                "max_abs_err", "ms", "device_ms", "bound_ms",
                "library_ms", "library_device_ms")}
            for case, dname, _, names in LONG_CASES if name in names
            for v in [kernels[(name, case, dname)]]}
        line.append({**extra,
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": f"src/repro/kernels/paged_attention.py:{line_no}",
            "launches": launches[name],
            "launches_by_body": by_body[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "device_ms": r["device_ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library_device_ms": r["library_device_ms"]})
    tiles = "bm=128 bn=128 bk=128"
    for name, source, replaces, key in (
            ("matmul", "matmul.cu", "matmul.py:45",
             ("full_width", "bfloat16", FULL_WIDTH, tiles)),
            ("single_tile_matmul", "matmul.cu", "matmul.py:75",
             ("tc_mma", "bfloat16", (256, 256, 256), "")),
            ("fp8_matmul", "fp8_matmul.cu", "fp8_matmul.py:38",
             ("full_width", "float8_e4m3fn", FULL_WIDTH, tiles)),
            ("pipelined_matmul", "async_pipeline.cu", "async_pipeline.py:79",
             ("full_width", "float32", FULL_WIDTH,
              "bm=64 bn=64 bk=64 stages=2"))):
        r = mm_results[(name,) + key]
        extra = {}
        if name == "fp8_matmul":
            # ops.fp8_matmul with auto tiles at the same shape
            extra["auto_tiles"] = {
                f"{case} {tag}": {k: v[k] for k in ("body", "max_abs_err",
                                                    "ms", "library_ms")}
                for (kern, case, _, _, tag), v in mm_results.items()
                if kern == "ops.fp8_matmul"}
        line.append({**extra,
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/kernels/{replaces}",
            "launches": mm_launches[name],
            "launches_by_body": mm_bodies[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    for name, source, replaces, case in (
            ("tropical_matmul", "dpx.cu", "kernels/dpx_kernel.py:48",
             f"{TROPICAL_FULL}/tma"),
            ("smith_waterman", "dpx.cu", "kernels/dpx_kernel.py:133",
             "x".join(map(str, SW_BATCH))),
            ("dpx_fused", "dpx.cu", "core/dpx.py:107",
             f"viaddmax_relu/int32/{DPX_N}"),
            ("rbc_ring_copy", "dsm.cu", "core/dsm.py:37", "4/3/4"),
            ("ring_latency_probe", "dsm.cu", "core/dsm.py:64", "4"),
            ("histogram_private", "dsm.cu", "core/dsm.py:77", "4096/4"),
            ("histogram_dsm", "dsm.cu", "core/dsm.py:93", "4096/4"),
            ("all_to_all_exchange", "dsm.cu", "core/dsm.py:118", "4")):
        r = dd_results[(name, case)]
        line.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"src/repro/{replaces}",
            "launches": dd_launches[name],
            **({"launches_by_body": dd_bodies[name]} if name in dd_bodies
               else {}),
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    r = flash_results["yi-6b"]
    line.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:62",
        "launches": (flash_launches["flash_attention"] + te_flash
                     + fam["flash"] + ssm["flash"] + ed["flash"]
                     + sharded["flash"] + families_sharded["flash"]),
        "launches_by_path": {"trainer": flash_launches["flash_attention"],
                             "te_layer": te_flash,
                             "families_trainer": fam["flash"],
                             "ssm_families_prefill":
                                 ssm["flash_by_path"]["prefill"],
                             "ssm_families_trainer":
                                 ssm["flash_by_path"]["trainer"],
                             "encdec_prefill":
                                 ed["flash_by_path"]["prefill"],
                             "encdec_trainer":
                                 ed["flash_by_path"]["trainer"],
                             "sharded_train": sharded["flash"],
                             "sharded_train_families":
                                 families_sharded["flash"]},
        "launches_by_body": {b: n + te_bodies.get(b, 0)
                             + fam["flash_bodies"].get(b, 0)
                             + ssm["flash_bodies"].get(b, 0)
                             + ed["flash_bodies"].get(b, 0)
                             + sharded["flash_bodies"].get(b, 0)
                             + families_sharded["flash_bodies"].get(b, 0)
                             for b, n in flash_bodies.items()},
        "sharded_train_shapes": sharded["shapes"],
        "sharded_train_families_shapes": {
            a: r["shapes"] for a, r in families_sharded["by_family"].items()},
        "max_abs_err": r["max_abs_err"], "ms": r["ms"],
        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
        "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        "zamba2_shared_block": ssm["flash_hd80"],
        **{case.replace("-", "_"): {k: flash_results[case][k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")} for case in ("whisper-enc", "whisper-cross",
                                        "yi-6b-fsdp-tp-shard",
                                        "moonshot-fsdp-tp-shard",
                                        "zamba2-fsdp-tp-shard",
                                        "whisper-enc-shard",
                                        "whisper-dec-shard",
                                        "whisper-cross-shard")}})
    # not TPU kernels: what each measures on the card, the reference
    # times on the host
    for name, case, replaces in (
            ("pchase", "global", "benchmarks/memory.py:22"),
            ("stream", "global", "benchmarks/memory.py:40"),
            ("onchip_bw", "shared", "benchmarks/memory.py:84")):
        r = mem_results[(name, case)]
        line.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/memory.cu",
            "replaces": f"not a TPU kernel ({replaces})",
            "launches": mem_launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]})
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": device}), flush=True)


if __name__ == "__main__":
    main()
