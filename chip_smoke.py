#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``polyrl_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA device and ``nvcc``; exits non-zero and prints no result
when CUDA is unavailable or any phase fails. Phases:

1. build   -- compile every kernel library from ``csrc/`` (K1-K4 and the
              fused decode prologue; one nvcc per source, all started
              together), and log each kernel's registers per thread and
              spill bytes from the compiler's ``-Xptxas -v`` report: a
              spill in a bf16 kernel fails.
2. kernels -- each kernel against its plain PyTorch version at the serving
              path's shapes (Hq 16, Hkv 8, D 128, page 64, 64 slots, bf16
              pools, lengths 1..4096, a G=8 group table with a padded -1
              seat): K1 bitwise; the fused decode prologue (qk-norm, RoPE
              and the K/V write in one kernel, K1 redesigned) with q and
              the written k rows within one bf16 ulp of each RoPE operand
              (``rope_operand_bound``), v rows and untouched rows bitwise,
              twice bitwise, a CUDA-graph replay bitwise the eager call,
              and failing with cos/sin one position late or k_norm left
              out; K2/K3 within rtol 1e-2 / atol 2e-3
              (outputs are rounded to bf16 once: one ulp is at most 2^-7
              of the value), K3 also against K2 on the full page tables,
              and K2 and K3 each twice on the same inputs, bitwise. The
              same calls with two slots missing their last page must fail
              that tolerance. K2 and K3 are also timed on the tables the
              serving phase gives them, K2 on those the train phase gives
              it, and each of their two launches (split, combine) on its
              own. K4 (training flash attention)
              through its wrapper ``flash_attention_train`` and autograd,
              forward and backward, against autograd through its plain
              version, at the train phase's shapes (B 4, T 512, Hq 16,
              Hkv 8, D 128, bf16) and at a long case (B 1, T 4096),
              with left- and right-padded rows and a row packed with 3
              segments: out within rtol 1e-2 / atol 2e-3, each of dq, dk,
              dv within a relative Frobenius error of 1e-2; the kernel
              with each row's first real token marked as pad must fail
              both; at the train shapes K4's backward run twice on the
              same inputs must give bitwise equal dq, dk, dv (no atomics,
              a fixed summation order). Times are device time per call:
              CUDA events around replays of a CUDA graph of back-to-back
              calls, median over several replays (backward passes through
              autograd -- the plain version's and SDPA's -- by CUDA events
              around back-to-back calls queued behind a spin kernel
              instead); K4's backward is also timed kernel by kernel
              (delta, dq, dk/dv and, where a kv head's q heads are
              split over blocks, the partials' sum; the tile ranges,
              which the forward makes for both, apart), and the
              log line gives the (q tile, k tile) pairs run and those
              skipped for disjoint segment ranges, and each bf16 kernel's
              registers and shared memory.
3. serve   -- ``create_server("qwen3-1.7b", device="cuda")`` at full width
              and depth with random weights from a seed; over HTTP, the
              main path: two GRPO groups of 8 samples (temperature 1.0,
              64 new tokens) sharing a ~200-token prompt plus two
              ungrouped greedy requests of 128 new tokens (decode with a
              live group goes through K3, ungrouped decode through K2),
              then one greedy request sent twice alone (same tokens).
              Launch counts are zeroed just before the main path and read
              just after it: every kernel must have launched (the mix's
              own are reported apart: whether its greedy tail outlives
              the groups depends on admission). The greedy request's
              logprobs are held against the port's dense ``forward`` on the
              card; sent again with the engine's decode attention missing
              each slot's last page, it must fail that check. The main
              path must take the fused prologue, never the standalone K1.
              The engine runs up to 16 dispatches ahead of emission and
              replays each decode dispatch from its key's CUDA graph. Run
              ahead against synchronous: the mix again at
              pipeline_depth 0, whose greedy streams must give the same
              tokens and logprobs bitwise where both runs admitted them
              in waves of one kind, size and prompt bucket (within 1e-3
              nats elsewhere), then once more at depth 16 under
              torch.profiler for the device's busy share; dispatches,
              replays, captures and host ms per dispatch are logged.
              Then the decode step's A/B (``decode_ab``) at the serving
              tables on the served weights: the default (fused) route
              against ``kv_write_fn=paged_kv_write`` (eager qk-norm and
              RoPE, then K1: that kernel's path), log-softmax within 0.1
              nats from the same pools and inputs, and the fused route
              captured as a CUDA graph (``graph``, a replay bitwise the
              eager step); then 50 steps of each in turns: wall and
              device ms and kernels per step. Then the engine's dispatch
              graph against its eager body (``engine_graph_checks``) on
              an engine of the served weights that admitted a greedy
              group, a sampled group (filters on) and two greedy
              requests: for an ungrouped key (K2) and a grouped key (K3),
              a replay bitwise the eager body from one snapshot (tokens,
              logprobs, done, state, pools), every sampled token in its
              filtered set with its logprob the filtered log-softmax's
              within 1e-5, one generator state giving the same tokens
              twice and the next replay other ones; and the profiler's
              count of the port's kernels over 3 replays equal to what
              the replays credited to the launch counts.
4. memory  -- the engine's memory plane on ``qwen3-1.7b`` at full width
              and depth (bf16, weights from seed 0): a capped engine of 8
              slots and 96 pages (0.70 GB of KV; pages cold after 4 idle
              dispatches; a 2 GB host spill tier) serves 16 greedy
              sessions of 512 random tokens and 64 new ones in two rounds
              of 8, then resumes each alone with its own prompt, so that
              published pages spill to pinned host buffers (gather on the
              compute stream, device-to-host on a copy stream) and restore
              in place on the prefix hit. Gates: at least 32 pages spilled
              and 32 restored; the streams bitwise a never-spilling
              engine's (1,024 pages) on the same requests, or the break
              named with equal tokens and logprobs within 5e-4; the same
              capped run with ``kv_spill=False`` equal tokens, logprobs
              within 5e-4 (its evicted prefixes prefill again instead of
              attaching); at quiescence the ledger reconciled (1.0: its
              roles the allocator's free list plus the cache's entries,
              spilled ones included), the flight deck's tokens reconciled,
              the loop profiler's attribution <= 1 + 1e-6 and accounting
              plus spill sweep under 15% of the loop's busy wall; the
              pools at their addresses and no decode graph captured again
              after the restores; a grouped mix (2 GRPO groups of 8,
              greedy, on two spilled 7-page prefixes) against the
              never-spilling engine, tokens equal or parting at a logged
              near-tie, logprobs within 5e-4; the fused prologue, K2 and
              K3 launched. Logs spill and restore GB/s (forced, and the
              sessions' own copies timed by events on the card), spills
              refused on a full copy lane, peak pinned bytes,
              ``kv_spilled_frac``, ``kv_restore_rate``, HBM use and
              headroom, and the profiler's device/accounting/idle
              fractions beside torch.profiler's busy share. Then the serve
              phase's mix on its engine with every plane on against
              ``kv_ledger=False, loop_profile=False``, 5 runs each in
              turns: median and range of tok/s, of host ms per dispatch in
              the launch and in the whole decode pass less its drains, and
              the profiler's accounting ms per dispatch; and the device
              memory peak of one full spill sweep on that engine's 2,048
              pages. Before the spill-off run, "tp spill": the same
              sessions on a tp=2 engine, both shards on the card, one
              spill lane a shard, against a never-spilling tp=2 engine of
              1,024 pages (both admitting each round held): at least 32
              pages spilled and restored through both lanes, the streams
              bitwise, the ledger reconciled, the pools at their addresses
              and no graph captured again, the fused prologue and K2 a
              multiple of 2 x 28; spill and restore GB/s summed and a lane,
              peak pinned bytes.
5. train   -- ``build_trainer`` of ``polyrl_tpu_torch.train``:
              ``qwen3-1.7b`` at full width and depth in bf16, random
              weights from seed 0, the colocated CB engine (64 slots,
              page 64, 512 pages), 2 GRPO steps of 2 prompts x 8 samples
              at T = 64 + 448, KL loss against a reference policy, remat
              on, a reward that varies within a group (the response's
              byte length). Gates: finite losses and grad norms, no
              skipped updates, weight_version 3 and the engine's weights
              bitwise the actor's, K4 fwd/bwd, the fused prologue and K2
              launched (counted from zero just before the fit; graph
              replays credit their captured launches), the trainer's step-1 old
              logprobs (K4) against the engine's rollout logprobs (paged
              decode), and the full-model loss gradient of one micro of
              step 1 on step 1's weights (the update's own gradient)
              through K4 against the same through the plain attention
              (cosine >= 0.98 on the bf16 weights, >= 0.99 on an f32
              copy; norm ratio within 2%). Each must fail with K4 fed
              tile-local segment ids (every query loses the keys of
              earlier tiles). ``--grad-seeds 1,2,...`` then reads the
              gradient gate again after the same fit at each of those
              ``trainer.seed`` values and logs the spread (not gated).
6. ppo     -- ``build_trainer`` again, on the slice's other half: PPO
              with a critic (GAE) on packed rows (pack_len 1024, 4 rows
              per micro), pipelined one step ahead (staleness limit 1,
              truncated importance correction), validation before
              training and after every step (8 arithmetic prompts,
              greedy); ``qwen3-1.7b`` at full width and depth in bf16, 2
              steps of 2 prompts x 8 samples, responses of 256 tokens.
              Gates: the fused prologue, K2 and K4 (forward and
              backward) launched,
              counted from zero; most packed rows carry 2 or more
              segments; the step-1 packed old logprobs within 0.2 nats of
              a padded pass over the same trajectories, and the packed
              values within PACKED_VALUE_TOL of the padded ones, while the
              same packs with each row's segments collapsed into one
              must fail the logprob gate; finite losses and grad norms,
              both grad norms > 0, no skipped update; step 2's tokens at
              most ``staleness_limit`` versions behind the weights they
              are trained against, each trajectory's versions (the
              version of each token's dispatch) never decreasing,
              finite importance weights <= the cap,
              and the engine bitwise the actor after the fit; validation
              finite, and twice on the same weights equal. Then on a
              depth-2 copy of the same widths: save at step 1, a fresh
              trainer resumes (step, dataloader and every parameter and
              optimizer tensor of actor and critic bitwise) and trains
              step 2; the host snapshot pageable against pinned staging
              buffers in turns. K4 is then timed at the packed rows'
              shapes and segment ids. ``--ppo-ab`` also runs the
              configuration without validation, unpipelined against
              pipelined in turns, for their step walls.
7. hf      -- ``qwen3-1.7b`` at full width and depth from seed 0 written
              as a Hugging Face checkpoint (two bf16 safetensors shards,
              the index, ``config.json``) into a temp dir and loaded back
              by ``build_from_hf`` on the card: the config and every leaf
              bitwise; the int8 load's seconds and bytes;
              ``create_server(model=<dir>)`` serves greedy tokens equal
              to the preset's on the seeded tree.
8. quant   -- ``quant.quantize_tensor`` on the card bitwise the same call
              on the host (int8 entries and f32 scales) on every
              projection of the seeded tree (the hf phase's host int8
              load likewise); then
              ``create_server("qwen3-1.7b", weight_quant="int8")`` serves
              the serve phase's mix and then a greedy request twice alone
              over HTTP (the fused prologue, K2 and K3 launched, counted
              from zero over both); the greedy runs the same tokens, their
              logprobs within 0.15 nats of the dense f32
              forward on the dequantized weights; a bf16
              ``update_weights`` refused and the same tree re-quantized
              through the server's ``weight_preprocess`` serving the same
              tokens; the decode step by graph replay, bf16 against int8
              (each replay bitwise its eager step): kernels, device and
              wall ms, the graph pool's growth.
9. lora    -- the train phase's configuration with ``actor.lora_rank=16``
              (2 GRPO steps): frozen leaves bitwise, every ``b`` moved,
              the engine bitwise ``merge_lora(actor.params)`` after each
              push, old logprobs within 0.2 nats of the engine's, K4
              forward and backward launched; trainable count, optimizer
              bytes, step walls and peak. Then optimizer offload: two
              full-width AdamW steps with offload bitwise the same
              without it, and the train phase's fit with
              ``actor.offload_optimizer=true trainer.profile_steps=2``:
              memory each offload frees, offload and load seconds, and a
              torch.profiler trace of step 2 naming K4's kernels.
10. features -- the CB engine's serving features on ``qwen3-1.7b`` at full
              width and depth (bf16, weights from seed 0, 64 slots, page
              64, 2,048 pages, run-ahead depth 16). salvage: a greedy
              stream of budget 400 aborted after its 5th token delivers
              every token of the dispatches issued for it before the
              ``abort`` terminal (1 + 8 per dispatch), ``tokens_salvaged``
              is what the drain delivered, and prompt + partial
              resubmitted hits the salvage-published pages and stitches to
              the uninterrupted run up to its first near-tie (a top-2
              logit gap under 0.05 in the dense forward); abort-to-terminal
              latency with salvage on and off in turns. chunked: a
              3,000-token prompt with ``prefill_chunk`` 512 against 0,
              first-token logprobs within 0.05 nats and greedy tokens
              equal up to the first near-tie, the peak memory of each; with
              16 greedy streams decoding, a decode dispatch between
              consecutive chunks and the streams' tok/s over the
              admission. spec: ``spec_tokens`` 4, ``spec_rounds`` 2 on the
              serve mix plus a repetitive greedy prompt, in turns with the
              plain engine: greedy streams equal up to the first
              near-tie, within 0.15 nats of the dense f32 forward, launches
              from zero (the fused prologue and K2, no K3), the spec
              dispatch's replay bitwise its eager body, the sampled verify
              rows inside their filtered sets, acceptance, tok/s and
              device ms per dispatch against the plain 8-step dispatch.
              warmup/release: over HTTP, release frees at least 14 GB and
              the captured graphs, resume, ``warmup()`` captures every
              decode key up front (the mix then captures none; its TTFT
              against the serve phase's), and the same greedy request is
              bitwise the one before release; the allocator whole after
              ``stop()``.
11. step   -- the step backend: ``RolloutEngine.generate`` on 16 prompts of
              128 tokens x 256 new tokens, greedy, against ``CBEngine`` (one
              run each, in one call): the same tokens up to the first near-tie, logprobs
              within 0.15 nats of the dense f32 forward, tok/s of each; a
              ``backend="step"`` server streams what its engine's
              ``generate`` gives; one GRPO step through ``build_trainer``
              with ``rollout.backend=step`` at the train phase's
              configuration (finite losses, grad norm > 0, K4 launched,
              the step engine's weights pushed).
12. disagg -- the disaggregated rollout: the port's C++ manager (its copy
              of the sources, built by ``g++`` into the git-ignored build
              directory) spawned supervised; ``build_trainer`` with
              ``rollout.mode=disaggregated`` and the train phase's
              configuration at REMOTE_CUT_LAYERS layers, as in the hybrid,
              lora_delta and autoscale phases (its weight sender
              registered first); then the rollout server as a subprocess
              at the same depth (``serve.main`` on its command line,
              ``python -c`` with ``model_overrides``: ``--model qwen3-1.7b
              --num-pages 512 --manager-endpoint ...``, bf16, on the card), whose
              receiver connects to that sender. 2 GRPO steps stream their
              groups back through the manager, each push goes over the TCP
              fabric (pack device to host, wire, install host to device,
              swap in place). Gates: finite losses, grad norms > 0; every
              push verified, none failed or retried; the server's
              ``weight_version`` at 1 + the steps; every streamed token
              tagged with its stream's version (staleness limit 1); a GRPO
              group of 8 on a 100-token prompt through the manager; after
              the last push a greedy request through the manager equal to
              an in-process ``CBEngine`` on the trainer's final parameters
              (or parting only at a near-tie), within 0.15 nats of the
              dense f32 forward; launches counted from zero: the fused
              prologue, K2 and K3 in the server process (its
              ``/get_server_info``), K4 forward and backward in the
              trainer's and no decode kernel there. Logs each push's
              split with GB/s, the version-raise latency, the step walls
              against the train phase's, the bubble, ``max_local_gen_s``,
              both processes' peak memory, and each step's generation as
              the server saw it (its ``/get_server_info`` polled every
              50 ms: the version's raise, the first admission, the first
              and last token, tok/s, graph captures). Then an int8 server
              (``--weight-quant int8``) joins and takes one push of the
              trainer's bf16 tree over the fabric, re-quantized on
              arrival: a greedy request on it equals an in-process int8
              ``CBEngine`` on ``quant.quantize_params`` of that tree (or
              parts only at a near-tie), within 0.15 nats of the dense f32
              forward on the dequantized weights. The balancer's feed: the
              server reports ``occupancy`` and ``device_frac`` (polled
              through the fit and logged), every step record carries the
              pool's ``engine/occupancy`` (> 0) and ``engine/device_frac``,
              the next step's balancer round passes them on, and a non-zero
              one of each reaches the estimator. Any failure (the
              manager's build, a server's death, a push) fails the smoke.
              The disagg phase also reads the server's ``/statusz``
              (memory, engine and its loop block) and ``/metrics``
              (``parse_prometheus_text``).
13. hybrid -- ``rollout.colocated_local=true`` beside a server subprocess
              (the train phase's configuration, traced): the local engine
              serves in the trainer's process and takes each push in
              process; finite losses, no dropped group, the local engine
              at 1 + steps bitwise the actor, its KV released (a release
              returns at least the pool's bytes), ``max_local_gen_s`` and
              ``critpath/*`` in every record, a 0.05 s window's stream
              aborted into continuation on the server at full length,
              greedy local against the server, a GRPO group on each
              engine; launches: the decode kernels in both processes, K4
              in the trainer's. Logs the local share, recaptures, walls,
              bubble and goodput against the disagg and train phases.
14. lora_delta -- ``trainer.weight_sync=lora_delta`` (rank 16) to a
              ``--lora-rank 16`` server: each push the adapter tree's
              bytes, installed in place (bitwise the pushed adapters, every
              leaf at its address, no recapture), the bases the actor's;
              greedy through the manager against an in-process engine on
              the wrapped tree and dense f32 on ``merge_lora``; the LoRA
              decode step against bf16 by replay.
15. autoscale -- closed-loop autoscaling on the disaggregated fit:
              ``build_trainer`` on the disagg phase's cell with
              ``rollout.autoscale`` on a [2, 2] envelope (hold 1, no
              cooldowns) and a step-paced ``rollout.spot_market`` whose
              trace (written to a temp file) offers server B, a ``serve``
              subprocess started before the fit in no pool, at step 1 and
              gives server A (registered through ``--manager-endpoint``) a
              preemption notice at step 3 (grace AUTOSCALE_GRACE_S); 5
              steps pipelined one step ahead, one trainer-side stream kill.
              Before the fit one push and a GRPO group on a one-page
              prompt through the manager (A alone, K3); after it the same
              group and a greedy request (B alone). Gates: five finite
              records, no dropped group, every response at full length or
              ended by EOS, one add (envelope repair at step 1) and
              ``no_capacity`` on every tick after the notice, tier 0 and
              no admission wait, ``fault/spot_offers`` and
              ``fault/spot_notices`` 1, a suffix resume; the trainer's
              ``/statusz`` autoscale section; B caught up through ``POST
              /attach_receiver`` and serving nothing before its first
              install; A's drain flushed within the grace, A idle after it;
              the greedy request on B against an in-process ``CBEngine``
              on the trained weights and the dense f32 forward; the planes;
              the fused prologue, K2 and K3 in both servers, K4 in the
              trainer; the controller's and the market's threads joined;
              the port's ``fleet_report``, ``engine_report`` and
              ``kv_report`` exit 0. ``--manager-args`` passes extra
              arguments to the manager of this phase and the disagg phase.
16. moe    -- the MoE family, run right after the kernels phase while the
              card's memory is empty (lines ``moe (``). K1, the fused
              prologue, K2, K3 and K4 forward and backward against their
              plain versions under the kernels phase's bounds at
              qwen3-30b-a3b's attention (32 q heads on 4 kv heads, D 128:
              rep 8; the kernel case's groups of 8 stack 64 query rows).
              ``create_server("qwen3-30b-a3b")`` at full width and 48
              layers (bf16, seed 0, the preset's capacity factor 2.0; 512
              pages) serves the serve phase's 18-stream mix over HTTP,
              graph-replayed at pipeline_depth 16, then one greedy request
              alone: the fused prologue, K2 and K3 launched (counted from
              zero); decode tok/s; the decode step by replay (device and
              wall ms, kernels) against the weight floor (every weight but
              the embedding read once a step). At capacity factor 16.0
              (E/k: dropless, so a token's output does not depend on its
              batch), on the same weights: greedy streams teacher-forced
              through the bf16 forward with a cache, logprobs within
              MOE_LOGP_TOL and tokens the forward's argmax until its first
              near-tie; an all-greedy batch dispatched by graph replay and
              by the eager body, K2 and K3 keys, the same tokens. At 2
              layers, full width: served greedy against the dense f32
              forward, within MOE_F32_TOL served in f32 (f32 weights and
              pools, the kernels' f32 instances) and within MOE_LOGP_TOL
              served in bf16; the tree written as a Qwen3-MoE
              checkpoint, loaded back bitwise and with ``quantize="int8"``
              bitwise ``quantize_params`` of the bf16 load (the router
              bf16), served int8 through the fused prologue, K2 and K3;
              the decode step bf16 against int8 by replay. Then
              ``build_trainer`` at 4 layers, dropless, 2 GRPO steps (the
              train phase's configuration): finite losses, K4 forward and
              backward launched, old logprobs within 0.2 nats of the
              engine's, the router and every expert leaf moved.
17. parallel -- the multi-process trainer (``polyrl_tpu_torch/parallel``)
              as two ranks on the one card: two processes of this script
              (``--parallel-worker``), both on cuda:0, backend gloo (NCCL
              refuses two ranks on one device), joined within
              PARALLEL_TIMEOUT_S (a hang or a failure on either rank fails
              the phase). A and D run the training cell at
              PARALLEL_CUT_LAYERS layers, C at TP_GRAD_LAYERS, B at its
              full depth. One 2-rank
              probe world first
              logs which
              collectives gloo takes on CUDA tensors as they are (the port
              stages them through the host).
              A: ``build_trainer`` on the train phase's configuration
              with ``parallel.fsdp=2`` (one GRPO step, rank 0's colocated
              engine; each layer's shard gathered inside its layer body,
              each rank's peak below the whole-tree route's A_PEAK_GB):
              after the step a digest of the gathered weights,
              equal on both ranks; step 1's old logprobs within
              LOGP_AGREE_TOL of the engine's; step 1's gate micro's
              gradient on the mesh against one rank's on the whole micro,
              cosine >= GRAD_COS_MIN_BF16; K4 forward and backward
              launched on both ranks, the fused prologue and K2 on rank 0.
              B: ``parallel.sp=2`` (Ulysses) on packed rows, one step: the
              first pack's logprobs under SP within LOGP_AGREE_TOL of the
              one-device forward, K4 run with segment ids on both ranks.
              Ring attention over the 2 ranks at B 1, T 4096 against K4
              alone, forward and backward, under K4's bounds. C:
              ``parallel.tp=2`` (each rank its tensor-parallel shard),
              one GRPO step: A's gates (old
              logprobs, the gradient against one rank's on the gathered
              weights, K4 on both ranks, the digest equal). D:
              ``parallel.pp=2`` (half the layers a stage, PP_MICRO GPipe
              microbatches), one step:
              A's gates, and the leaves pp does not split (the embedding,
              the final norm) bitwise equal on both ranks. E:
              ``parallel.ep=2`` on qwen3-30b-a3b at full width and
              EP_LAYERS layers (64 experts a rank), one step: the gradient
              against one rank's, the router and every expert block moved,
              the router bitwise equal on both ranks, K4 on both. Logs
              step 1's micro gradient by leaf family (cosine and norm
              ratio, mesh vs one rank) for A, C, D and E, the
              step walls by phase ("two ranks sharing one card"), each
              rank's peak, its parameter and AdamW bytes, the push's
              gathered bytes. Its launches stay out of the ``kernels``
              line.
18. tp     -- (run right after serve) ``create_server(tp=2)``, ``serve
              --tp 2``'s engine: ``qwen3-1.7b`` at full width and depth,
              bf16, seed 0, two shards of 8 q / 4 kv heads on the one card,
              each with its own pools: the serve phase's 18-stream mix
              over HTTP graph-replayed, then one greedy request alone,
              counts zeroed just before and read just after (the fused
              prologue, K2 and K3 each a multiple of 2 shards x 28
              layers); its greedy streams against a one-shard engine on
              the same weights, tokens equal until the first f32 near-tie
              and logprobs within TP_LOGP_TOL before it; at 2 layers in
              f32 the same within MOE_F32_TOL; the decode step at the
              serving tables by replay on 2 shards and on 1 (device and
              wall ms, kernels, launches; from the same K/V, the 2-shard
              step's log-softmax no further than TP_STEP_RATIO times the
              one-shard step's from the same step in f32); one push of the whole tree through the
              fabric into the server's receiver (``transfer_shard_tp`` 2),
              every shard's installed blocks bitwise the sender's slices.
              Then the same on qwen3-30b-a3b at full width and
              TP_MOE_LAYERS layers, dropless ("tp moe"): each shard half of
              every expert's width and the whole router, its launches in
              the ``kernels`` line's tp share. Then "tp lora":
              ``create_server(tp=2, lora_rank=16)`` (``serve --tp 2
              --lora-rank 16``) on ``qwen3-1.7b``; one adapter push of
              ``extract_adapters`` (a and b drawn from a seeded generator)
              through the sharded fabric: every shard's a/b bitwise its
              ``tp_dim`` block of the push, the bases as before, every leaf
              at its address, no graph captured again; then the 18-stream
              mix held to one admission order, and one greedy request
              alone, as the main path (the fused prologue, K2 and K3 each
              a multiple of 2 x 28, the unfused K1 not): its greedy
              streams bitwise a fresh tp=2 LoRA server's given the same
              adapters, and against a one-shard LoRA engine until the
              first f32 near-tie within TP_LOGP_TOL; the decode step by
              replay on 2 shards and on 1; the push's bytes, wire and
              install seconds.
              The hybrid phase also fails when its short window's stream
              takes over HYBRID_WINDOW_MAX_S.
19. recipe -- (run after autoscale, before parallel) the north-star
              recipe ``examples/configs/stream_grpo_llama3_8b.yaml``
              through ``load_config``, ``build_trainer`` and ``fit`` at
              llama3-8b's full width (GQA rep 4, llama3 RoPE scaling, an
              untied 128,256-row head, no qk-norm) and REMOTE_CUT_LAYERS
              layers, the reference worker's shape (the manager spawned by
              ``train``, the colocated local engine, speculation, packing,
              offload, remat): its cuts and gates in ``recipe_phase``. The
              kernels phase runs the kernel case once more at its layout
              (``layout_kernels`` at Hq 32, Hkv 8: the fused prologue
              with null norms; K4 at B 4, T 512).
20. result -- the card's name and power limit, a ``{"kernels": [...]}``
              line (the launches of each kernel's paths: serve or the A/B,
              memory and its tp spill, train, disagg, hybrid, lora_delta,
              autoscale, recipe, moe and tp, tp moe and tp lora), and last
              ``{"ok": true, "device": {...}}``.

The train, disagg, hybrid, lora_delta, autoscale and recipe phases also
gate the observability planes: every record's ``goodput/*``
(``attributed_frac`` in [0.95, 1.05]) and
``training/*``; the train phase polls the trainer's
``/statusz`` through the fit, checks that a healthy fit dumps no
flight-recorder bundle and that a manual one holds the CUDA memory
snapshot, and logs the planes' host ms a step.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import contextlib
import dataclasses
import gc
import http.client
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

from polyrl_tpu_torch.manager.client import build_manager
from polyrl_tpu_torch.models import decoder
from polyrl_tpu_torch.ops import cuda_build
from polyrl_tpu_torch.ops import flash
from polyrl_tpu_torch.ops import norm_rope
from polyrl_tpu_torch.ops import paged_attention as pa

MODEL = "qwen3-1.7b"
HQ, HKV, D, PS, S = 16, 8, 128, 64, 64
P = 4096 // PS                 # page-table columns (max_seq_len 4096)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12            # dense bf16 tensor-core peak, same source
# K2/K3 against their plain versions: both round their f32 result to bf16
# once, so they may differ by one bf16 ulp (at most 2^-7 of the value, under
# rtol); atol covers outputs near zero (half a bf16 ulp at 1 is 2^-9)
KERNEL_TOL = dict(rtol=1e-2, atol=2e-3)
# engine logprobs vs the dense forward with f32 weights and activations, in
# nats: the engine runs bf16 activations through 28 layers, and the bf16
# dense forward itself lands about 0.08 nats from f32 at the worst of 64
# tokens; the limit is about twice that
DENSE_LOGP_TOL = 0.15
# K4 against its plain version: out as K2/K3 (bf16 output rounded once);
# each gradient by relative Frobenius error, which a one-ulp bf16 rounding
# of every element keeps near 2^-9
FLASH_OUT_TOL = dict(rtol=1e-2, atol=2e-3)
FLASH_GRAD_TOL = 1e-2
# the fused decode prologue against its plain chain: q and the written k
# rows within one bf16 ulp (2^-7 of the value) of each RoPE operand and of
# the result (``rope_operand_bound``); v rows and untouched rows bitwise
FUSED_REL = 2.0 ** -7
# the decode step's two routes (fused prologue; eager qk-norm/RoPE + K1)
# from the same pools and inputs, log-softmax over the vocabulary of the
# live slots, in nats: both round q and k to bf16 at the same points, and
# differ where the sum of squares flips a rounding (one ulp), compounded
# through 28 layers
DECODE_AB_TOL = 0.1
F32_FLOPS = 67e12              # H100 SXM f32 outside the tensor cores, same source
REPLACES = {
    "paged_kv_write": "polyrl_tpu/ops/paged_attention.py:672",
    "paged_kv_write_fused": "polyrl_tpu/ops/paged_attention.py:672 with the "
                            "qk-norm and RoPE of polyrl_tpu/models/decoder.py:731-735",
    "paged_attention": "polyrl_tpu/ops/paged_attention.py:160",
    "grouped_paged_attention": "polyrl_tpu/ops/paged_attention.py:462",
    "flash_attention_fwd": "polyrl_tpu/ops/flash.py:60",
    "flash_attention_bwd": "polyrl_tpu/ops/flash.py:60",
}
# the kernels each phase's main path must launch (the standalone K1 is on
# the decode step's unfused route, driven by the serve phase's A/B)
SERVE_KERNELS = ("paged_kv_write_fused", "paged_attention",
                 "grouped_paged_attention")
TRAIN_KERNELS = ("flash_attention_fwd", "flash_attention_bwd",
                 "paged_kv_write_fused", "paged_attention")


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# each phase's wall in seconds, in the order run (the ``phase walls`` line)
WALLS: dict[str, float] = {}


@contextlib.contextmanager
def phase_wall(name: str):
    """Add the wall of the block to ``WALLS[name]``."""
    t0 = time.monotonic()
    try:
        yield
    finally:
        WALLS[name] = WALLS.get(name, 0.0) + time.monotonic() - t0


def cuda_ms(fn, reps: int, inner: int = 1, warmup: int = 2) -> float:
    """Per-call device ms: a CUDA graph of ``inner`` back-to-back calls is
    replayed between CUDA events, elapsed / inner, median over ``reps``
    replays. The graph takes the host's launch cost out: a kernel of a few
    microseconds would otherwise be timed at the rate Python issues it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    del graph
    return statistics.median(times)


def bound_ms(n_bytes: float, flops: float, peak: float = BF16_FLOPS
             ) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# -- phase 2: kernels at the serving path's shapes ------------------------------


def kernel_case(dev):
    """Pools, per-slot page tables and a grouped table. Slots 0..30 sit in
    four GRPO groups (three of 8, one of 7 padded to 8 with a -1 seat)
    that share 32/16/8/4-page prompt chains; slots 31..63 are ungrouped."""
    rng = np.random.default_rng(0)
    groups = [(8, 32), (8, 16), (8, 8), (7, 4)]   # (members, prefix pages)
    lens, rows, pre_pages, seats = [], [], [], []
    next_page = 1

    def take(n):  # sequential ids here, shuffled over the pool below
        nonlocal next_page
        next_page += n
        return list(range(next_page - n, next_page))

    for g, n_pre in groups:
        chain = take(n_pre)
        pre_pages.append(chain)
        seat = []
        for _ in range(g):
            ln = n_pre * PS + int(rng.integers(1, 513))
            own = take(-(-ln // PS) - n_pre)
            seat.append(len(rows))
            rows.append(chain + own)
            lens.append(ln)
        seats.append(seat)
    while len(rows) < S:
        ln = int(rng.integers(1, 4097))
        rows.append(take(-(-ln // PS)))
        lens.append(ln)
    lens[31], lens[32], lens[33] = 1, 4096, 65   # edges: 1 token, full row
    rows[31], rows[32], rows[33] = take(1), take(64), take(2)
    n_pool = next_page
    perm = np.concatenate([[0], rng.permutation(np.arange(1, n_pool))])
    rows = [[int(perm[x]) for x in r] for r in rows]
    pre_pages = [[int(perm[x]) for x in r] for r in pre_pages]
    table = np.zeros((S, P), np.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = r
    ng, gmax, p_pre = 4, 8, 32
    g_slots = np.full((ng, gmax), -1, np.int32)
    g_pages = np.zeros((ng, p_pre), np.int32)
    g_lens = np.zeros((ng,), np.int32)
    for i, (seat, chain) in enumerate(zip(seats, pre_pages)):
        g_slots[i, :len(seat)] = seat
        g_pages[i, :len(chain)] = chain
        g_lens[i] = len(chain) * PS
    gen = torch.Generator(device=dev).manual_seed(0)
    pool_shape = (HKV, n_pool, PS, D)
    kp = torch.randn(pool_shape, generator=gen, device=dev, dtype=torch.bfloat16)
    vp = torch.randn(pool_shape, generator=gen, device=dev, dtype=torch.bfloat16)
    q = torch.randn((S, HQ, D), generator=gen, device=dev, dtype=torch.bfloat16)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return dict(q=q, kp=kp, vp=vp, table=t(table),
                lens=t(np.asarray(lens, np.int32)), g_slots=t(g_slots),
                g_pages=t(g_pages), g_lens=t(g_lens), lens_np=np.asarray(lens),
                g_lens_np=g_lens, seats=seats)


def rope_operand_bound(n, cos, sin, ref, rel):
    """Elementwise limit for a RoPE output whose operands may each sit one
    ulp (``rel`` of their value) from the plain chain's: out1 = n1 cos -
    n2 sin and out2 = n2 cos + n1 sin move by at most rel * (|n1 cos| +
    |n2 sin|) (resp. |n2 cos| + |n1 sin|), and rounding the result adds
    rel * |out|. ``n`` [S, H, D] holds the operands (the normalised rows
    as the plain chain rounds them), ``cos``/``sin`` [S, D/2]. A limit of
    ``rel * |ref|`` alone fails a healthy kernel wherever the two products
    cancel and the f32 sum of squares, summed in another order, flips one
    bf16 rounding of an operand. 1e-6 covers values near 0."""
    h = n.shape[-1] // 2
    n1, n2 = n[..., :h].float().abs(), n[..., h:].float().abs()
    c, s = cos.float().abs()[:, None], sin.float().abs()[:, None]
    scale = torch.cat([n1 * c + n2 * s, n2 * c + n1 * s], dim=-1)
    return rel * (scale + ref.float().abs()) + 1e-6


def fused_inputs(dev, c) -> dict:
    """The fused prologue's operands at the kernel case: the projected q,
    k, v rows of 64 slots (bf16), ``MODEL``'s qk-norm weights (1 + 0.1
    noise; None, the null norms, for a preset without qk-norm such as
    llama3-8b) and RoPE at each slot's position (with the preset's RoPE
    scaling), written at that position in the slot's page row: at its last
    cached position, so every target is a row of its own. Slot 5 is
    inactive (page 0, offset 0); slots 6 and 7 sit at offset 0 and PS - 1
    of their last page."""
    cfg = decoder.get_config(MODEL)
    gen = torch.Generator(device=dev).manual_seed(3)
    pos = (c["lens"].long() - 1).clamp(min=0)
    start = pos[6:8] // PS * PS
    pos[6], pos[7] = start[0], start[1] + PS - 1
    page = c["table"][torch.arange(S, device=dev), pos // PS].int()
    off = (pos % PS).int()
    page[5], off[5] = 0, 0
    cos, sin = decoder.rope_cos_sin(cfg, pos[:, None])

    def r(*shape, scale=1.0, base=0.0):
        x = torch.randn(shape, generator=gen, device=dev, dtype=torch.float32)
        return (base + scale * x).to(torch.bfloat16)

    norms = cfg.use_qk_norm
    return dict(write_page=page, write_off=off, q=r(S, HQ * D), k=r(S, HKV * D),
                v=r(S, HKV * D), cos=cos[:, 0], sin=sin[:, 0],
                q_norm=r(D, scale=0.1, base=1.0) if norms else None,
                k_norm=r(D, scale=0.1, base=1.0) if norms else None,
                eps=cfg.rms_norm_eps, pos=pos)


def norm_or_not(x, weight, eps):
    """``x`` per-head RMS-normalised by ``weight``, or ``x`` itself where
    the weight is None (a preset without qk-norm)."""
    return x if weight is None else norm_rope.rms_norm(x, weight, eps)


def fused_gate(a: dict, out: tuple, ref: tuple, pools: tuple) -> dict:
    """``out`` and ``ref`` (q, k_pool, v_pool) of the fused prologue on
    ``a``, from the same ``pools``: q and the written k rows within
    ``rope_operand_bound`` (the ratio of |diff| to it must stay <= 1), the
    v pool bitwise, every other k row bitwise the original. Returns the
    readings and ``ok``."""
    q, kp, vp = out
    rq, rk, rv = ref
    s, hq, d = rq.shape
    hkv, n = kp.shape[:2]
    eps = a["eps"]
    n_q = norm_or_not(a["q"].reshape(s, 1, hq, d), a["q_norm"], eps)[:, 0]
    n_k = norm_or_not(a["k"].reshape(s, 1, hkv, d), a["k_norm"], eps)[:, 0]
    rows = ((torch.arange(hkv, device=q.device)[:, None] * n
             + a["write_page"].long()[None]) * PS + a["write_off"].long()[None])
    got_k = kp.view(-1, d)[rows].transpose(0, 1)   # [S, Hkv, D]
    ref_k = rk.view(-1, d)[rows].transpose(0, 1)
    err_q = (q.float() - rq.float()).abs()
    err_k = (got_k.float() - ref_k.float()).abs()
    ratio_q = (err_q / rope_operand_bound(n_q, a["cos"], a["sin"], rq,
                                          FUSED_REL)).max().item()
    ratio_k = (err_k / rope_operand_bound(n_k, a["cos"], a["sin"], ref_k,
                                          FUSED_REL)).max().item()
    plain_ulp = int((err_q > FUSED_REL * rq.float().abs() + 1e-6).sum()
                    + (err_k > FUSED_REL * ref_k.float().abs() + 1e-6).sum())
    untouched = torch.ones(kp.view(-1, d).shape[0], dtype=torch.bool,
                           device=kp.device)
    untouched[rows.reshape(-1)] = False
    rest_ok = torch.equal(kp.view(-1, d)[untouched], pools[0].view(-1, d)[untouched])
    v_ok = torch.equal(vp, rv)
    return dict(ok=ratio_q <= 1 and ratio_k <= 1 and rest_ok and v_ok,
                ratio_q=ratio_q, ratio_k=ratio_k, rest_ok=rest_ok, v_ok=v_ok,
                max_abs_err=max(err_q.max().item(), err_k.max().item()),
                plain_ulp=plain_ulp)


def check_fused(dev, c, empty: float) -> dict:
    """The fused decode prologue (K1 redesigned) at the kernel case,
    against its plain chain: the gate of ``fused_gate``, two calls bitwise
    equal, one replay of a CUDA-graph capture bitwise the eager call; the
    gate must fail with cos/sin of position + 1 and with k_norm left out
    (with null norms: with k normalised by unit weights).
    Times by graph replay: the kernel, its plain chain, and the decode
    step's unfused route (eager qk-norm and RoPE, then K1)."""
    a = fused_inputs(dev, c)
    base = (c["kp"], c["vp"])
    args = {k_: a[k_] for k_ in ("write_page", "write_off", "q", "k", "v",
                                 "cos", "sin", "q_norm", "k_norm", "eps")}

    def run(fn, **over):
        kp, vp = base[0].clone(), base[1].clone()
        q = fn(kp, vp, **dict(args, **over))
        return q, kp, vp

    ref = run(pa.paged_kv_write_fused_ref)
    out = run(pa.paged_kv_write_fused)
    torch.cuda.synchronize()
    g = fused_gate(a, out, ref, base)
    check(g["ok"], f"paged_kv_write_fused differs from its plain version: {g}")
    again = run(pa.paged_kv_write_fused)
    check(all(torch.equal(x, y) for x, y in zip(out, again)),
          "paged_kv_write_fused differs between two calls on the same inputs")
    del again
    gk, gv = base[0].clone(), base[1].clone()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        gq = pa.paged_kv_write_fused(gk, gv, **args)
    graph.replay()
    torch.cuda.synchronize()
    check(torch.equal(gq, out[0]) and torch.equal(gk, out[1])
          and torch.equal(gv, out[2]),
          "paged_kv_write_fused: a graph replay differs from the eager call")
    del graph, gq, gk, gv
    # the gate's power: RoPE one position late, and k not normalised (with
    # null norms: k normalised)
    cfg = decoder.get_config(MODEL)
    cos1, sin1 = decoder.rope_cos_sin(cfg, a["pos"][:, None] + 1)
    faults = {"cos/sin of position + 1": dict(cos=cos1[:, 0], sin=sin1[:, 0])}
    if a["k_norm"] is None:
        faults["k normalised"] = dict(k_norm=torch.ones(
            D, device=dev, dtype=torch.bfloat16))
    else:
        faults["k_norm left out"] = dict(k_norm=None)
    fault_lines = []
    for label, over in faults.items():
        fg = fused_gate(a, run(pa.paged_kv_write_fused, **over), ref, base)
        check(not fg["ok"], f"the fused gate passes a planted fault: {label}")
        fault_lines.append(f"{label}: q {fg['ratio_q']:.3g}, k {fg['ratio_k']:.3g}")
    log(f"kernel paged_kv_write_fused (Hq {HQ}, Hkv {HKV}, "
        f"{'qk-norm' if a['q_norm'] is not None else 'null norms'}): "
        f"max_abs_err {g['max_abs_err']:.3g}; "
        f"|diff| / one-ulp-of-the-RoPE-operands limit: q {g['ratio_q']:.3f}, k "
        f"{g['ratio_k']:.3f} (<= 1); {g['plain_ulp']} elements beyond one ulp "
        f"of the result alone (RoPE cancellation); v rows and untouched rows "
        f"bitwise; twice bitwise; graph replay bitwise; planted faults (limit "
        f"ratios, must exceed 1): " + "; ".join(fault_lines))

    kp, vp = base[0].clone(), base[1].clone()
    ms = cuda_ms(lambda: pa.paged_kv_write_fused(kp, vp, **args), 20, inner=20)
    plain = cuda_ms(lambda: pa.paged_kv_write_fused_ref(kp, vp, **args), 20,
                    inner=20)
    q4 = a["q"].reshape(S, 1, HQ, D)
    k4 = a["k"].reshape(S, 1, HKV, D)
    v3 = a["v"].reshape(S, HKV, D)
    cos3, sin3 = a["cos"][:, None], a["sin"][:, None]

    def unfused():  # forward_paged_decode with kv_write_fn=paged_kv_write
        qn = norm_or_not(q4, a["q_norm"], a["eps"])
        kn = norm_or_not(k4, a["k_norm"], a["eps"])
        qr = norm_rope.apply_rope(qn, cos3, sin3)
        kr = norm_rope.apply_rope(kn, cos3, sin3)
        pa.paged_kv_write(kp, vp, a["write_page"], a["write_off"], kr[:, 0], v3)
        return qr

    route = cuda_ms(unfused, 20, inner=20)
    es = 2
    norms = a["q_norm"] is not None  # null norms: no weights, no norm
    n_bytes = ((S * (HQ + 2 * HKV) * D + (2 * D if norms else 0)) * es
               + S * D * 4 + 2 * S * 4 + (S * HQ * D + 2 * S * HKV * D) * es)
    # square-sum, scale, weight (with qk-norm), rotate
    flops = (10.0 if norms else 3.0) * S * (HQ + HKV) * D
    b, how = bound_ms(n_bytes, flops, F32_FLOPS)
    log(f"kernel paged_kv_write_fused: {ms:.5f} ms = {ms / empty:.2f} x the "
        f"empty kernel ({empty:.5f}); bound {b:.5f} ms ({how}, {n_bytes} B); "
        f"plain chain {plain:.5f} ms; the unfused route (eager qk-norm and "
        f"RoPE, then K1) {route:.5f} ms")
    return dict(name="paged_kv_write_fused", max_abs_err=g["max_abs_err"],
                ms=ms, plain_ms=plain, bound_ms=b, bound_by=how,
                library_ms=None)


def check_kernels(dev) -> list[dict]:
    c = kernel_case(dev)
    q, kp, vp, table, lens = c["q"], c["kp"], c["vp"], c["table"], c["lens"]
    gargs = (c["g_slots"], c["g_pages"], c["g_lens"])
    lens_np = c["lens_np"]
    es = 2  # bf16 bytes
    rows = []

    # K1: one decode step's K/V rows into each slot's next position
    k_upd = torch.randn((S, HKV, D), device=dev, dtype=torch.bfloat16)
    v_upd = torch.randn_like(k_upd)
    pos = torch.clamp(lens, max=P * PS - 1)
    page = table[torch.arange(S, device=dev), (pos // PS).long()].int()
    off = (pos % PS).int()
    page[5] = 0  # an inactive slot routed to the null page
    off[5] = 0
    ref_k, ref_v = kp.clone(), vp.clone()
    pa.paged_kv_write_ref(ref_k, ref_v, page, off, k_upd, v_upd)
    out_k, out_v = kp.clone(), vp.clone()
    pa.paged_kv_write(out_k, out_v, page, off, k_upd, v_upd)
    torch.cuda.synchronize()
    check(torch.equal(out_k, ref_k) and torch.equal(out_v, ref_v),
          "paged_kv_write differs from its plain version")
    del ref_k, ref_v
    ms = cuda_ms(lambda: pa.paged_kv_write(out_k, out_v, page, off, k_upd,
                                           v_upd), 20, inner=20)
    plain = cuda_ms(lambda: pa.paged_kv_write_ref(out_k, out_v, page, off,
                                                  k_upd, v_upd), 20, inner=20)
    flat_k = out_k.view(-1, D)
    flat_v = out_v.view(-1, D)
    head_off = torch.arange(HKV, device=dev)[:, None] * (out_k.shape[1] * PS)
    idx = (head_off + (page.long() * PS + off.long())[None, :]).reshape(-1)
    rk = k_upd.transpose(0, 1).reshape(-1, D)
    rv = v_upd.transpose(0, 1).reshape(-1, D)
    lib = cuda_ms(lambda: (flat_k.index_copy_(0, idx, rk),
                           flat_v.index_copy_(0, idx, rv)), 20, inner=20)
    b, how = bound_ms(4 * S * HKV * D * es + 2 * S * 4, 0.0)
    rows.append(dict(name="paged_kv_write", max_abs_err=0.0, ms=ms,
                     plain_ms=plain, bound_ms=b, bound_by=how, library_ms=lib))
    # K1's launch floor: the device time of an empty kernel (a spin of 0
    # cycles) and of a one-element add, timed as K1 is
    one = torch.zeros(1, device=dev)
    empty = cuda_ms(lambda: torch.cuda._sleep(0), 20, inner=20)
    add1 = cuda_ms(lambda: one.add_(1.0), 20, inner=20)
    log(f"kernel paged_kv_write: launch floor by CUDA-graph replay: empty "
        f"kernel {empty:.5f} ms, one-element add {add1:.5f} ms; K1 "
        f"{ms:.5f} ms = {ms / empty:.2f} x the empty kernel (bound {b:.5f})")
    del out_k, out_v
    rows.append(check_fused(dev, c, empty))

    # K2: decode attention over the full page rows
    out2 = pa.paged_attention(q, kp, vp, table, lens)
    ref2 = pa.paged_attention_ref(q, kp, vp, table, lens)
    torch.cuda.synchronize()
    err2 = (out2.float() - ref2.float()).abs().max().item()
    check(torch.allclose(out2.float(), ref2.float(), **KERNEL_TOL),
          f"paged_attention differs from its plain version (max {err2})")
    check(torch.equal(out2, pa.paged_attention(q, kp, vp, table, lens)),
          "paged_attention differs between two calls on the same inputs")
    toks = int(np.maximum(lens_np, 1).sum())
    io = 2 * S * HQ * D * es + S * 4 + 4 * int(np.ceil(np.maximum(lens_np, 1) / PS).sum())
    b, how = bound_ms(io + 2 * HKV * D * es * toks, 4.0 * HQ * D * toks)
    rows.append(dict(
        name="paged_attention", max_abs_err=err2,
        ms=cuda_ms(lambda: pa.paged_attention(q, kp, vp, table, lens), 10,
                   inner=5),
        plain_ms=cuda_ms(lambda: pa.paged_attention_ref(q, kp, vp, table, lens), 5),
        bound_ms=b, bound_by=how, library_ms=None))

    # K3: grouped two-phase attention, against its plain version and K2
    out3 = pa.grouped_paged_attention(q, kp, vp, table, lens, *gargs)
    ref3 = pa.grouped_paged_attention_ref(q, kp, vp, table, lens, *gargs)
    torch.cuda.synchronize()
    err3 = (out3.float() - ref3.float()).abs().max().item()
    check(torch.allclose(out3.float(), ref3.float(), **KERNEL_TOL),
          f"grouped_paged_attention differs from its plain version (max {err3})")
    err32 = (out3.float() - out2.float()).abs().max().item()
    check(torch.allclose(out3.float(), out2.float(), **KERNEL_TOL),
          f"grouped_paged_attention differs from paged_attention (max {err32})")
    check(torch.equal(out3, pa.grouped_paged_attention(q, kp, vp, table, lens, *gargs)),
          "grouped_paged_attention differs between two calls on the same inputs")
    log("kernel paged_attention, grouped_paged_attention: two calls on the "
        "same inputs give bitwise equal outputs")
    # the tolerance's power: the full 4,096-token row (slot 32) and a grouped
    # slot each missing their last page must fail it
    cut = lens.clone()
    for i in (32, c["seats"][0][0]):
        cut[i] -= (cut[i] - 1) % PS + 1
    miss = []
    for name, fn, ref in (
            ("paged_attention", lambda: pa.paged_attention(
                q, kp, vp, table, cut), ref2),
            ("grouped_paged_attention", lambda: pa.grouped_paged_attention(
                q, kp, vp, table, cut, *gargs), ref3)):
        bad = fn().float()
        miss.append(f"{name} {(bad - ref.float()).abs().max().item():.3g}")
        check(not torch.allclose(bad, ref.float(), **KERNEL_TOL),
              f"{name}: the tolerance passes a missing page")
    del ref2, ref3
    pre_tok = sum(int(x) for x in c["g_lens_np"])
    own_tok = 0  # tokens each slot reads past its group's shared prefix
    for s in range(S):
        n_pre = 0
        for gi, seat in enumerate(c["seats"]):
            if s in seat:
                n_pre = int(c["g_lens_np"][gi])
        own_tok += int(max(lens_np[s], 1)) - n_pre
    io3 = io + 4 * (c["g_slots"].numel() + c["g_pages"].numel() + 4)
    b, how = bound_ms(io3 + 2 * HKV * D * es * (pre_tok + own_tok),
                      4.0 * HQ * D * toks)
    rows.append(dict(
        name="grouped_paged_attention", max_abs_err=err3,
        ms=cuda_ms(lambda: pa.grouped_paged_attention(q, kp, vp, table, lens,
                                                      *gargs), 10, inner=5),
        plain_ms=cuda_ms(lambda: pa.grouped_paged_attention_ref(
            q, kp, vp, table, lens, *gargs), 5),
        bound_ms=b, bound_by=how, library_ms=None))
    for r in rows:
        log(f"kernel {r['name']}: max_abs_err {r['max_abs_err']:.3g} "
            f"ms {r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms {r['library_ms']}")
    log(f"kernel grouped_paged_attention vs paged_attention: max_abs_err {err32:.3g}")
    log(f"kernel gate power: max_abs_err with two slots missing their last "
        f"page: {', '.join(miss)} (each fails the tolerance)")
    log("kernel case by launch: " + launch_times(q, kp, vp, table, lens, gargs))
    serving_times(dev, kp, vp)
    train_table_times(dev, kp, vp)
    return rows


def launch_times(q, kp, vp, table, lens, gargs) -> str:
    """Device ms of each of K2's and K3's two launches (split, combine),
    through the wrappers' launchers, which count no launches; K2 alone
    without ``gargs``."""
    parts = []
    cases = [("paged_attention", pa.paged_attention_launcher(q, kp, vp, table, lens))]
    if gargs is not None:
        cases.append(("grouped_paged_attention", pa.grouped_paged_attention_launcher(
            q, kp, vp, table, lens, *gargs)))
    for name, (out, run) in cases:
        run(1)
        ms = {part: cuda_ms(lambda: run(phases), 10, inner=10)
              for part, phases in (("split", 1), ("combine", 2))}
        parts.append(f"{name} split {ms['split']:.4f}, combine {ms['combine']:.4f}")
        del out
    return "; ".join(parts)


def serving_tables(dev):
    """The tables the serving phase gives K2 and K3 mid-decode: 64 slots;
    two GRPO groups of 8 on 200- and 203-token prompts (3 shared prefix
    pages, bucketed to 4) at 232 and 235 tokens; two greedy slots; 46 idle
    slots (length 0 on the null page). Returns (page table, lengths, group
    tables) on ``dev``."""
    table = np.zeros((S, P), np.int32)
    lens = np.zeros((S,), np.int32)
    g_slots = np.full((2, 8), -1, np.int32)
    g_pages = np.zeros((2, 4), np.int32)
    g_lens = np.full((2,), 3 * PS, np.int32)
    nxt, slot = 1, 0
    for g, n_tok in enumerate((232, 235)):
        g_pages[g, :3] = range(nxt, nxt + 3)
        for i in range(8):
            table[slot, :4] = [*g_pages[g, :3], nxt + 3 + i]
            lens[slot] = n_tok
            g_slots[g, i] = slot
            slot += 1
        nxt += 3 + 8
    for n_tok in (230, 237):
        table[slot, :4] = range(nxt, nxt + 4)
        lens[slot] = n_tok
        nxt, slot = nxt + 4, slot + 1
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(table), t(lens), (t(g_slots), t(g_pages), t(g_lens))


def serving_times(dev, kp, vp) -> None:
    """K2 and K3 on the serving tables (``serving_tables``)."""
    table, lens, gargs = serving_tables(dev)
    q = torch.randn((S, HQ, D), device=dev, dtype=torch.bfloat16)
    out2 = pa.paged_attention(q, kp, vp, table, lens)
    out3 = pa.grouped_paged_attention(q, kp, vp, table, lens, *gargs)
    for name, out, ref in (
            ("paged_attention", out2,
             pa.paged_attention_ref(q, kp, vp, table, lens)),
            ("grouped_paged_attention", out3, pa.grouped_paged_attention_ref(
                q, kp, vp, table, lens, *gargs)),
            ("grouped_paged_attention vs paged_attention", out3, out2)):
        check(torch.allclose(out.float(), ref.float(), **KERNEL_TOL),
              f"serving tables: {name} disagrees")
    ms2 = cuda_ms(lambda: pa.paged_attention(q, kp, vp, table, lens), 20,
                  inner=20)
    ms3 = cuda_ms(lambda: pa.grouped_paged_attention(q, kp, vp, table, lens,
                                                     *gargs), 20, inner=20)
    toks = int(np.maximum(lens.cpu().numpy(), 1).sum())
    b2, _ = bound_ms(2 * HKV * D * 2 * toks, 4.0 * HQ * D * toks)
    b3, _ = bound_ms(2 * HKV * D * 2 * (toks - 14 * 3 * PS),
                     4.0 * HQ * D * toks)
    log(f"kernel serving tables: paged_attention ms {ms2:.4f} (bound {b2:.4f}), "
        f"grouped_paged_attention ms {ms3:.4f} (bound {b3:.4f}); by launch: "
        + launch_times(q, kp, vp, table, lens, gargs))


def train_table_times(dev, kp, vp) -> None:
    """K2 on the tables the train phase gives it (64 slots, page 64,
    max_seq_len 512: 8 page-table columns; 16 live sequences at 64-512
    tokens, 48 idle slots), where it is launched 25,088 times a run."""
    rng = np.random.default_rng(2)
    p = 512 // PS
    table = np.zeros((S, p), np.int32)
    lens = np.zeros((S,), np.int32)
    lens[:16] = rng.integers(64, 513, 16)
    table[:16] = 1 + rng.permutation(kp.shape[1] - 1)[:16 * p].reshape(16, p)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    table, lens_t = t(table), t(lens)
    q = torch.randn((S, HQ, D), device=dev, dtype=torch.bfloat16)
    out = pa.paged_attention(q, kp, vp, table, lens_t)
    check(torch.allclose(out.float(), pa.paged_attention_ref(
        q, kp, vp, table, lens_t).float(), **KERNEL_TOL),
        "train tables: paged_attention disagrees")
    ms = cuda_ms(lambda: pa.paged_attention(q, kp, vp, table, lens_t), 20, inner=20)
    toks = int(np.maximum(lens, 1).sum())
    b, _ = bound_ms(2 * HKV * D * 2 * toks, 4.0 * HQ * D * toks)
    log(f"kernel train-phase tables: paged_attention ms {ms:.4f} (bound {b:.4f}, "
        f"{toks} tokens); by launch: {launch_times(q, kp, vp, table, lens_t, None)}")


# -- phase 2b: K4, training flash attention, forward and backward ---------------


def flash_inputs(dev, b: int, t: int, seed: int):
    """bf16 q/k/v/dout ([B, T, H, D], the model's layout) and f32 / int32
    [B, T] mask and segment ids. Row 0 is left-padded (prompt-style), the
    last row right-padded (response-style) and row 1 (or the only row)
    packs 3 segments followed by pads."""
    rng = np.random.default_rng(seed)
    mask = np.ones((b, t), np.float32)
    seg = np.ones((b, t), np.int32)
    if b > 1:
        mask[0, :t // 8] = 0
        mask[b - 1, t - t // 5:] = 0
    packed = 1 if b > 1 else 0
    cuts = (t // 5, t // 2, t - t // 16)
    seg[packed] = 0
    seg[packed, :cuts[0]], seg[packed, cuts[0]:cuts[1]] = 1, 2
    seg[packed, cuts[1]:cuts[2]] = 3
    mask[packed] = (seg[packed] > 0).astype(np.float32)
    for i in range(b):
        if i != packed:
            seg[i] = mask[i].astype(np.int32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev,  # noqa: E731
                                   dtype=torch.bfloat16)
    return dict(q=r(b, t, HQ, D), k=r(b, t, HKV, D), v=r(b, t, HKV, D),
                do=r(b, t, HQ, D), mask=torch.from_numpy(mask).to(dev),
                seg=torch.from_numpy(seg).to(dev))


def visible_pairs(seg: torch.Tensor) -> int:
    """(query, key) pairs the causal segment mask lets through, per head:
    what this input's work is (a causal kernel skips the tiles above the
    diagonal; what it then masks inside a tile is not work it needs)."""
    t = seg.shape[1]
    causal = torch.ones((t, t), dtype=torch.bool, device=seg.device).tril()
    same = seg[:, :, None] == seg[:, None, :]
    return int((same & causal).sum())


SPIN_CYCLES = 100_000_000  # about 50 ms of the SM clock


def events_ms(fn, reps: int, warmup: int = 1) -> float:
    """Per-call device ms of back-to-back calls between CUDA events, for
    work a CUDA graph cannot capture (autograd backward passes). The calls
    are queued behind a spin kernel, so the device runs them back to back
    even where the host issues them slower than the device runs them
    (autograd's host cost can exceed a short backward's device time); a
    check fails if the host took longer to queue them than the spin
    lasted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    s = torch.cuda.Event(enable_timing=True)
    s.record()
    torch.cuda._sleep(SPIN_CYCLES)
    a.record()
    t0 = time.monotonic()
    for _ in range(reps):
        fn()
    host_ms = (time.monotonic() - t0) * 1e3
    b.record()
    b.synchronize()
    check(host_ms < s.elapsed_time(a),
          f"events_ms: queueing took {host_ms:.1f} ms, longer than the "
          f"{s.elapsed_time(a):.1f} ms spin")
    return a.elapsed_time(b) / reps


def flash_bwd_parts_ms(q, k, v, seg, o, lse, do, ranges, reps: int,
                       inner: int) -> dict:
    """Device ms of each kernel of K4's backward, launched by its entry
    point with the arguments ``flash.flash_bwd_cuda`` gives it (raw entry
    points, so they are not counted as launches): delta, dq, dk/dv and,
    when the backward splits a kv head's q heads over blocks, the
    partials' sum; and the tile ranges, which the forward makes for
    both."""
    b, t, hq, d = q.shape
    hkv = k.shape[2]
    code, scale = cuda_build.DTYPE_CODE[q.dtype], float(d ** -0.5)
    n_split = flash.dkv_splits(b, t, hq, hkv)
    delta = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    part = torch.empty((2, n_split, b, t, hkv, d), dtype=torch.float32,
                       device=q.device) if n_split > 1 else None
    pp = None if part is None else part.data_ptr()
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg.data_ptr(),
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), ranges.data_ptr())
    shape = (code, b, t, hq, hkv, d, 1)

    def call(entry, *args, lib="flash_attention_bwd"):
        return lambda: cuda_build.launch(  # the stream is the capturing one
            lib, *args, cuda_build.stream_of(q.device), entry=f"polyrl_flash_{entry}")

    calls = {"delta": call("attention_bwd_delta", o.data_ptr(), do.data_ptr(),
                           delta.data_ptr(), code, b, t, hq, d),
             "dq": call("attention_bwd_dq", *ptrs, dq.data_ptr(), *shape, scale),
             "dk/dv": call("attention_bwd_dkv", *ptrs, dk.data_ptr(), dv.data_ptr(),
                           pp, *shape, n_split, scale)}
    if part is not None:
        calls[f"dk/dv sum of {n_split}"] = call(
            "attention_bwd_dkv_sum", pp, dk.data_ptr(), dv.data_ptr(), b, t, hkv, d,
            n_split)
    calls["delta"]()
    out = {name: cuda_ms(fn, reps, inner) for name, fn in calls.items()}
    out["(forward's tile ranges)"] = cuda_ms(
        call("segment_ranges", seg.data_ptr(), ranges.data_ptr(), b, t,
             lib="flash_attention_fwd"), reps, inner)
    return out


def k4_resources(d: int) -> str:
    """Registers (the ``-Xptxas -v`` report) and dynamic shared memory (the
    launchers' own sizes) of K4's bf16 kernels at head dim ``d``."""
    regs = {r["kernel"]: r["registers"]
            for name in K4_NAMES for r in cuda_build.ptxas_report(name)}
    smem = {"fwd": cuda_build.library("flash_attention_fwd")
            .polyrl_flash_attention_fwd_smem(d),
            "dq": cuda_build.library("flash_attention_bwd")
            .polyrl_flash_attention_bwd_smem(0, d),
            "dkv": cuda_build.library("flash_attention_bwd")
            .polyrl_flash_attention_bwd_smem(1, d)}
    return ", ".join(f"{k_} {regs[f'flash_{k_}_bf16_kernel<{d}>']} registers "
                     f"{smem[k_]} B shared" for k_ in ("fwd", "dq", "dkv"))


def wrapper_grads(fn, q, k, v, mask, seg, do):
    """``fn(q, k, v, mask, segment_ids=seg)`` on fresh leaves, and the
    gradients of ``<out, do>``: (out, (dq, dk, dv))."""
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    out = fn(*leaves, mask, segment_ids=seg)
    return out.detach(), torch.autograd.grad(out, leaves, do)


def flash_case_check(dev, b: int, t: int, seed: int, label: str, reps: int,
                     repeat: bool = False, seg_np=None):
    """K4 through its public wrapper (``flash_attention_train`` and its
    autograd Function) against autograd through its plain version on one
    case; the planted fault (each row's first real token marked as pad)
    must fail both the output and the gradient tolerances; with
    ``repeat``, two backward calls on the same inputs must agree bitwise.
    ``seg_np`` ([b, t] int32) replaces the case's segment ids and mask
    (packed rows from the trainer). Returns (fwd row, bwd row) without
    launches."""
    c = flash_inputs(dev, b, t, seed)
    q, k, v, do, mask, seg = (c[x] for x in ("q", "k", "v", "do", "mask", "seg"))
    if seg_np is not None:
        seg = torch.from_numpy(np.ascontiguousarray(seg_np, np.int32)).to(dev)
        mask = (seg > 0).float()
    o, (dq, dk, dv) = wrapper_grads(flash.flash_attention_train, q, k, v, mask,
                                    seg, do)
    leaves = [x.detach().clone().requires_grad_(True) for x in (q, k, v)]
    ref = flash.flash_attention_train_ref(*leaves, mask, segment_ids=seg)
    rdq, rdk, rdv = torch.autograd.grad(ref, leaves, do, retain_graph=True)
    torch.cuda.synchronize()

    def rel(g, rg):
        return ((g.float() - rg.float()).norm() / rg.float().norm()).item()

    err_o = (o.float() - ref.float()).abs().max().item()
    check(o.dtype == q.dtype and torch.allclose(o.float(), ref.float(),
                                                **FLASH_OUT_TOL),
          f"K4 forward ({label}) differs from its plain version (max {err_o})")
    grad_err = {}
    for name, g, rg, x in (("dq", dq, rdq, q), ("dk", dk, rdk, k),
                           ("dv", dv, rdv, v)):
        grad_err[name] = rel(g, rg)
        check(g.dtype == x.dtype and g.shape == x.shape
              and grad_err[name] <= FLASH_GRAD_TOL
              and torch.isfinite(g).all().item(),
              f"K4 backward ({label}) {name} relative error "
              f"{grad_err[name]:.3g} > {FLASH_GRAD_TOL}")
    err_g = max((g.float() - rg.float()).abs().max().item()
                for g, rg in ((dq, rdq), (dk, rdk), (dv, rdv)))
    # planted fault: each row's first real token marked as pad
    bad_seg = seg.clone()
    first = (seg > 0).int().argmax(dim=1)
    bad_seg[torch.arange(b, device=dev), first] = 0
    bo, bad_grads = wrapper_grads(flash.flash_attention_train, q, k, v, mask,
                                  bad_seg, do)
    torch.cuda.synchronize()
    bad_o = (bo.float() - ref.float()).abs().max().item()
    bad_g = {n: rel(g, rg) for n, g, rg in zip(("dq", "dk", "dv"), bad_grads,
                                                (rdq, rdk, rdv))}
    check(not torch.allclose(bo.float(), ref.float(), **FLASH_OUT_TOL),
          f"K4 ({label}): the output tolerance passes a missing first token")
    check(max(bad_g.values()) > FLASH_GRAD_TOL,
          f"K4 ({label}): the gradient tolerance passes a missing first token")
    log(f"kernel flash_attention ({label}, B {b} T {t}): out max_abs_err "
        f"{err_o:.3g}; grads relative error "
        + ", ".join(f"{n} {e:.3g}" for n, e in grad_err.items())
        + f"; planted fault (first real token as pad): out {bad_o:.3g}, "
        + ", ".join(f"{n} {e:.3g}" for n, e in bad_g.items())
        + " (fails the out and the gradient checks)")
    del bo, bad_grads

    # the device's tile ranges, against their plain version
    ranges = flash.tile_ranges(q, seg)
    check(torch.equal(ranges.cpu(), flash.segment_tile_ranges(seg.cpu())),
          f"K4 tile ranges ({label}) differ from segment_tile_ranges")
    _, lse = flash.flash_fwd_cuda(q, k, v, seg, True, ranges)
    if repeat:
        # determinism: the backward twice on the same inputs, bitwise
        first = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True, ranges)
        second = flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True, ranges)
        torch.cuda.synchronize()
        check(all(torch.equal(a, b_) for a, b_ in zip(first, second)),
              f"K4 backward ({label}) differs between two calls on the same inputs")
        log(f"kernel flash_attention ({label}): the backward twice on the "
            f"same inputs gives bitwise equal dq, dk, dv")
        del first, second

    # times: the kernels' launchers by graph replay (the backward needs the
    # forward's LSE, and takes its tile ranges as the autograd Function
    # hands them over); autograd backward passes by events
    inner = max(1, 2048 // t)
    ms_f = cuda_ms(lambda: flash.flash_fwd_cuda(q, k, v, seg, True,
                                                flash.tile_ranges(q, seg)), reps, inner)
    ms_b = cuda_ms(lambda: flash.flash_bwd_cuda(q, k, v, seg, o, lse, do, True,
                                                ranges), reps, inner)
    parts = flash_bwd_parts_ms(q, k, v, seg, o, lse, do, ranges, reps, inner)
    plain_f = cuda_ms(lambda: flash.flash_attention_train_ref(
        q, k, v, mask, segment_ids=seg), reps)
    plain_b = events_ms(lambda: torch.autograd.grad(ref, leaves, do,
                                                    retain_graph=True), reps)
    del ref
    vis = ((seg[:, :, None] == seg[:, None, :])
           & torch.ones((t, t), dtype=torch.bool, device=dev).tril())[:, None]
    qt, kt_, vt = (x.transpose(1, 2) for x in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    lib_f = cuda_ms(lambda: sdpa(qt, kt_, vt, attn_mask=vis, enable_gqa=True),
                    reps, inner)
    lleaves = [x.detach().clone().requires_grad_(True) for x in (qt, kt_, vt)]
    lout = sdpa(*lleaves, attn_mask=vis, enable_gqa=True)
    dot = do.transpose(1, 2)
    lib_b = events_ms(lambda: torch.autograd.grad(lout, lleaves, dot,
                                                  retain_graph=True), reps)
    lerr = (lout.detach().transpose(1, 2).float() - o.float()).abs().max().item()
    del lout, lleaves

    pairs = visible_pairs(seg)
    run, skipped = flash.tiles_run(ranges)  # the device's own table
    es = 2
    io_f = (2 * q.numel() + k.numel() + v.numel()) * es + lse.numel() * 4 + seg.numel() * 4
    io_b = (4 * q.numel() + 2 * (k.numel() + v.numel())) * es + lse.numel() * 4 \
        + seg.numel() * 4
    bf, hf = bound_ms(io_f, 4.0 * D * HQ * pairs)
    bb, hb = bound_ms(io_b, 10.0 * D * HQ * pairs)
    log(f"kernel flash_attention ({label}): fwd ms {ms_f:.4f} (plain {plain_f:.4f}, "
        f"SDPA {lib_f:.4f}, bound {bf:.4f} by {hf}); bwd ms {ms_b:.4f} (plain "
        f"{plain_b:.4f}, SDPA {lib_b:.4f}, bound {bb:.4f} by {hb}); "
        f"bwd by kernel: " + ", ".join(f"{n} {ms:.4f}" for n, ms in parts.items())
        + f"; {pairs} visible pairs per head; (q tile, k tile) pairs per head "
        f"over the batch run {run}, skipped for disjoint segment ranges "
        f"{skipped} (of {run + skipped} causal); bf16 kernels at D {D}: "
        f"{k4_resources(D)}; SDPA vs K4 out max diff {lerr:.3g}; "
        f"plain and SDPA backward timed by CUDA events around {reps} "
        f"back-to-back autograd calls queued behind a spin kernel")
    fwd = dict(name="flash_attention_fwd", max_abs_err=err_o, ms=ms_f,
               plain_ms=plain_f, bound_ms=bf, bound_by=hf, library_ms=lib_f)
    bwd = dict(name="flash_attention_bwd", max_abs_err=err_g, ms=ms_b,
               plain_ms=plain_b, bound_ms=bb, bound_by=hb, library_ms=lib_b)
    return fwd, bwd


def check_flash(dev) -> list[dict]:
    """K4 at the train phase's shapes (its rows in the kernels line) and at
    the long case (logged)."""
    rows = flash_case_check(dev, 4, 512, 7, "train phase shapes", reps=10,
                            repeat=True)
    torch.cuda.empty_cache()
    flash_case_check(dev, 1, 4096, 8, "long case", reps=3)
    torch.cuda.empty_cache()
    return list(rows)


def k4_sass_counts() -> dict | None:
    """``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in each of
    K4's bf16 kernels, read from ``cuobjdump -sass`` of its library: {kernel:
    (hgmma, utmaldg)}, or None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.isfile(tool):
        return None
    counts = {}
    for name in K4_NAMES:
        text = subprocess.run([tool, "-sass", str(cuda_build.lib_path(name))],
                              capture_output=True, text=True, timeout=120,
                              check=True).stdout
        fn = None
        for line in text.splitlines():
            if "Function :" in line:
                fn = cuda_build.kernel_name(line.split("Function :")[1].strip())
                if "bf16_kernel" in fn:
                    counts[fn] = [0, 0]
                else:
                    fn = None
            elif fn is not None:
                counts[fn][0] += "HGMMA" in line
                counts[fn][1] += "UTMALDG" in line
    return {k_: tuple(v) for k_, v in counts.items()}


def build_report() -> None:
    """Each K2, K3, K4 and fused-prologue kernel's registers per thread
    and spill bytes, from the ``-Xptxas -v`` report of its library's
    build; the bf16 kernels (the serving and training paths) must not
    spill. K4's bf16 kernels must hold wgmma and TMA loads in their SASS
    where the toolkit has cuobjdump."""
    for name in ("paged_kv_write_fused", "paged_attention",
                 "grouped_paged_attention", "flash_attention_fwd",
                 "flash_attention_bwd"):
        rows = cuda_build.ptxas_report(name)
        check(rows, f"{name}: no ptxas report in its build log")
        log(f"build {name}: " + "; ".join(
            f"{r['kernel']} {r['registers']} registers, spill stores/loads "
            f"{r['spill_stores']}/{r['spill_loads']} B" for r in rows))
        for r in rows:
            check("bf16" not in r["kernel"] or r["spill_stores"] + r["spill_loads"] == 0,
                  f"{r['kernel']} spills {r['spill_stores']}/{r['spill_loads']} bytes")
    sass = k4_sass_counts()
    if sass is None:
        log("build K4: no cuobjdump in the toolkit; SASS not read")
        return
    log("build K4 SASS (HGMMA, UTMALDG) per bf16 kernel: " + json.dumps(sass))
    check(len(sass) == 6 and all(h > 0 and u > 0 for h, u in sass.values()),
          f"K4's bf16 kernels lack wgmma or TMA loads in their SASS: {sass}")


# -- phase 3: the engine over HTTP -------------------------------------------------


def stream_generate(port: int, body: dict, out: dict) -> None:
    """POST /generate and record each NDJSON line with its arrival time."""
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    t0 = time.monotonic()
    conn.request("POST", "/generate", json.dumps(body),
                 {"Content-Type": "application/json"})
    resp = conn.getresponse()
    lines = []
    while True:
        raw = resp.readline()
        if not raw:
            break
        if raw.strip():
            lines.append((time.monotonic(), json.loads(raw)))
    conn.close()
    out.update(t0=t0, status=resp.status, lines=lines,
               tokens=[t for _, ln in lines for t in ln["token_ids"]],
               logprobs=[x for _, ln in lines for x in ln["logprobs"]],
               reason=lines[-1][1]["finish_reason"] if lines else "none")


def post(port: int, path: str, body: dict | None = None) -> dict:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    if body is None:
        conn.request("GET", path)
    else:
        conn.request("POST", path, json.dumps(body),
                     {"Content-Type": "application/json"})
    resp = conn.getresponse()
    data = json.loads(resp.read())
    conn.close()
    check(resp.status == 200, f"{path}: HTTP {resp.status}")
    return data


def get_text(port: int, path: str) -> str:
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("GET", path)
    resp = conn.getresponse()
    data = resp.read().decode()
    conn.close()
    check(resp.status == 200, f"{path}: HTTP {resp.status}")
    return data


def server_planes(port: int, label: str) -> dict:
    """A rollout server's /statusz (the memory section, the engine
    section's flight deck and loop block) and its /metrics, parsed with the
    port's ``parse_prometheus_text``."""
    from polyrl_tpu_torch import obs
    from polyrl_tpu_torch.obs import statusz

    sz = post(port, "/statusz", None)
    eng_ = sz["engine"]
    check(sz["schema"] == statusz.SCHEMA and sz["role"] == "rollout"
          and all(k_ in sz for k_ in statusz.REQUIRED_SECTIONS),
          f"{label}: the server's /statusz misses sections")
    check(sz["memory"].get("reconcile", {}).get("attributed_frac") == 1.0
          and sz["memory"].get("roles"),
          f"{label}: the server's /statusz memory section: {sz['memory']}")
    check(eng_.get("loop", {}).get("enabled") is True
          and {"tokens", "requests", "occupancy", "pages"} <= set(eng_),
          f"{label}: the server's /statusz engine section: {sorted(eng_)}")
    text = get_text(port, "/metrics")
    metrics = obs.parse_prometheus_text(text)
    check(metrics.get("polyrl_total_tokens_served", 0) > 0
          and "polyrl_weight_version" in metrics,
          f"{label}: the server's /metrics: {text[:300]}")
    return dict(sections=sorted(sz), loop_device_frac=eng_["loop"].get(
        "window", {}).get("device_frac"), metrics=len(metrics),
        attributed=eng_["tokens"].get("attributed_frac"))


def run_requests(port: int, bodies: list[dict], engine=None) -> list[dict]:
    """Stream ``bodies`` at once over /generate and check each ran to its
    length. With ``engine`` (the server's), its admission is held until
    every request is queued, in the order of ``bodies``: every run of the
    same requests on an idle engine admits the same waves."""
    outs = [{} for _ in bodies]
    threads = [threading.Thread(target=stream_generate, args=(port, b, o))
               for b, o in zip(bodies, outs)]
    if engine is not None:
        engine._paused.set()
    for i, t in enumerate(threads):
        t.start()
        deadline = time.monotonic() + 60
        # the idle loop may have taken the first into its pending list
        while (engine is not None
               and engine._queue.qsize() + len(engine._pending) <= i):
            check(time.monotonic() < deadline, "a held request never queued")
            time.sleep(0.001)
    if engine is not None:
        engine._paused.clear()
    for t in threads:
        t.join(timeout=900)
        check(not t.is_alive(), "a /generate stream did not finish")
    for b, o in zip(bodies, outs):
        check(o.get("status") == 200, f"{b['rid']}: HTTP {o.get('status')}")
        want = b["sampling_params"]["max_new_tokens"]
        check(o["reason"] == "length" and len(o["tokens"]) == want,
              f"{b['rid']}: finish {o['reason']!r} after {len(o['tokens'])} tokens")
    return outs


@contextlib.contextmanager
def profiled(out_path: str | None):
    """With ``out_path``, trace the block with torch.profiler and print the
    device time by kernel (also written to ``out_path``)."""
    if not out_path:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    t0 = time.monotonic()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        yield
    torch.cuda.synchronize()
    wall_us = (time.monotonic() - t0) * 1e6
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:25]
    lines = [f"profile: wall {wall_us / 1e3:.1f} ms, device busy "
             f"{busy / 1e3:.1f} ms ({busy / wall_us:.3f} of wall)"]
    lines += [f"profile: {dev_us(e) / 1e3:9.2f} ms {e.count:7d}x {e.key[:90]}"
              for e in top if dev_us(e) > 0]
    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    with open(out_path, "w") as f:
        f.write("\n".join(lines) + "\n")
    for ln in lines:
        log(ln)


def serving_mix(vocab: int) -> tuple[list[dict], list[list[int]], list[int]]:
    """The serving main path's requests: two GRPO groups of 8 (temperature
    1.0, 64 new tokens) on 200- and 203-token prompts and two greedy
    requests of 128 tokens on 198- and 205-token prompts; with the greedy
    prompts and a 150-token warm-up prompt (all drawn from one seed)."""
    rng = np.random.default_rng(1)
    prompt = lambda n: rng.integers(1, vocab, n).tolist()  # noqa: E731
    group_prompts = [prompt(200), prompt(203)]
    greedy_prompts = [prompt(198), prompt(205)]
    bodies = []
    for g, gp in enumerate(group_prompts):
        bodies += [{"rid": f"g{g}-{i}", "input_ids": gp,
                    "group_id": f"grp{g}", "group_size": 8,
                    "sampling_params": {"temperature": 1.0,
                                        "max_new_tokens": 64}}
                   for i in range(8)]
    bodies += [{"rid": f"greedy{i}", "input_ids": gp,
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 128}}
               for i, gp in enumerate(greedy_prompts)]
    return bodies, greedy_prompts, prompt(150)


def serve_phase(dev, model: str = MODEL, profile: str | None = None) -> dict:
    from polyrl_tpu_torch.rollout.serve import create_server

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    server = create_server(model, device=str(dev), host="127.0.0.1", port=0,
                           max_slots=64, page_size=64, max_seq_len=4096,
                           num_pages=2048, steps_per_dispatch=8, seed=0)
    try:
        log(f"serve: {model} up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        port = server.port
        check(post(port, "/health", None)["status"] == "ok", "/health")
        cfg = server.engine.cfg
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)

        # one short request first: CUDA/cuBLAS initialise lazily, and that
        # one-time cost must not land in the measured TTFT
        run_requests(port, [{"rid": "warmup", "input_ids": warm,
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})

        # the main path: the mix, then one greedy request twice alone from
        # an empty prefix cache (identical inputs and batch shapes must give
        # identical tokens); counts zeroed just before it and read just
        # after. Whether the mix alone ends on an ungrouped dispatch (K2)
        # depends on when its greedy streams were admitted (one dispatch of
        # 17 in most runs, none in some); the lone request always does.
        info0 = post(port, "/get_server_info", None)
        cuda_build.reset_launch_counts()
        t_start = time.monotonic()
        with profiled(profile):
            outs = run_requests(port, bodies)
        wall = time.monotonic() - t_start
        mix_launches = dict(cuda_build.LAUNCHES)
        info = post(port, "/get_server_info", None)
        rep = []
        for i in range(2):
            post(port, "/flush_cache", {})
            rep.append(run_requests(port, [{
                "rid": f"repeat{i}", "input_ids": greedy_prompts[0],
                "sampling_params": {"temperature": 0.0,
                                    "max_new_tokens": 64}}])[0])
        launches = dict(cuda_build.LAUNCHES)
        info_all = post(port, "/get_server_info", None)
        for name in SERVE_KERNELS:
            check(launches[name] > 0,
                  f"{name} was not launched on the serving path")
            check(info_all[f"kernel_launches/{name}"] == launches[name],
                  "server_info launch counts disagree")
        check(launches["paged_kv_write"] == 0,
              "the serving path took the unfused K/V write")
        delta = {k: info[k] - info0[k] for k in (
            "decode_dispatches", "grouped_decode_dispatches",
            "sibling_attach_dispatches")}
        log(f"serve: main path launches {json.dumps(launches)} (the mix's "
            f"{json.dumps(mix_launches)}); the mix: {json.dumps(delta)}; "
            + dispatch_line(info0, info))
        decode_tok_s = mix_tok_s(outs)
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0,
                  "non-finite or positive logprob")
            check(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                  "token outside the vocabulary")
        ttft = [o["lines"][0][0] - o["t0"] for o in outs]
        check(rep[0]["tokens"] == rep[1]["tokens"],
              "the same greedy request gave different tokens")
        single = (rep[0]["lines"][-1][0] - rep[0]["lines"][0][0]) / 63
        log(f"serve: one stream alone (twice): TTFT {(rep[0]['lines'][0][0] - rep[0]['t0']) * 1e3:.1f} ms, "
            f"{single * 1e3:.2f} ms per decode step (64 slots computed); "
            f"launches " + json.dumps({k_: launches[k_] - mix_launches[k_]
                                        for k_ in launches}))
        runahead = runahead_against_sync(port, server.engine, bodies, outs)
        log(f"serve: {len(outs)} streams, "
            f"{sum(len(o['tokens']) for o in outs)} tokens in {wall:.2f} s")
        # decode vs dense: the engine's greedy logprobs against the port's
        # dense forward over prompt + generated tokens, on the card, in f32
        # (the reference) and in bf16 (the same precision as the engine)
        n_p = len(greedy_prompts[0])

        def dense_logprobs(params, tokens):
            x = torch.tensor([greedy_prompts[0] + tokens], device=dev)
            pos = torch.arange(x.shape[1], device=dev)[None]
            logits, _ = decoder.forward(params, cfg, x, pos,
                                        torch.ones_like(x, dtype=torch.float32),
                                        attn_fn=flash.flash_attention_train_ref)
            return torch.log_softmax(logits[0, n_p - 1:-1].float(), dim=-1)

        params32 = {k: ({kk: vv.float() for kk, vv in v.items()}
                        if isinstance(v, dict) else v.float())
                    for k, v in server.engine.params.items()}

        def against_dense(out):
            """Max |engine - dense f32| logprob, the max f32 gap of the chosen
            tokens below the best, and the argmax agreement."""
            gen = torch.tensor(out["tokens"], device=dev)
            lsm32 = dense_logprobs(params32, out["tokens"])
            ref = lsm32.gather(-1, gen[:, None])[:, 0]
            err = (ref - torch.tensor(out["logprobs"], device=dev)).abs().max()
            return (err.item(), (lsm32.max(dim=-1).values - ref).max().item(),
                    (lsm32.argmax(dim=-1) == gen).float().mean().item(), ref)

        lp_err, gap, agree, ref_lp = against_dense(rep[0])
        gen = torch.tensor(rep[0]["tokens"], device=dev)
        lsm16 = dense_logprobs(server.engine.params, rep[0]["tokens"])
        bf16_err = (lsm16.gather(-1, gen[:, None])[:, 0] - ref_lp).abs().max().item()
        log(f"serve: decode vs dense f32: max |logprob diff| {lp_err:.4f} nats "
            f"(dense bf16 vs f32: {bf16_err:.4f}), max f32 gap of the chosen "
            f"token {gap:.4f}, argmax agreement {agree:.3f} "
            f"(tolerance {DENSE_LOGP_TOL})")
        check(lp_err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
              f"paged decode disagrees with the dense forward ({lp_err:.4f} "
              f"and {gap:.4f} nats, limit {DENSE_LOGP_TOL})")
        # the gate's power: the same request, with the engine's decode
        # attention missing each slot's last page, must fail it
        post(port, "/flush_cache", {})
        with missing_last_page(server.engine):
            bad = run_requests(port, [{
                "rid": "fault", "input_ids": greedy_prompts[0],
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 64}}])[0]
        bad_err, bad_gap, bad_agree, _ = against_dense(bad)
        log(f"serve: gate power: with each slot's last page missing, max "
            f"|logprob diff| {bad_err:.4f} nats, max gap {bad_gap:.4f}, "
            f"argmax agreement {bad_agree:.3f} (fails the tolerance)")
        check(max(bad_err, bad_gap) > DENSE_LOGP_TOL,
              "the dense gate passes a missing page")
        del params32
        ab = decode_ab(dev, server.engine.params, cfg)
        graphs = engine_graph_checks(dev, server.engine.params, cfg)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        log("serve: served " + engine_line(server.engine))
        log(f"serve: peak memory {peak_gb:.2f} GB (torch.cuda."
            f"max_memory_allocated, the served engine and the checks' own)")
        return dict(launches=launches, ttft=ttft, decode_tok_s=decode_tok_s,
                    wall=wall, ab_launches=ab, runahead=runahead, graphs=graphs,
                    peak_gb=peak_gb)
    finally:
        server.stop()


def mix_tok_s(outs: list[dict]) -> float:
    """Decode tokens per second over the mix: every token after each
    stream's first, from the first stream's first token to the last
    stream's last."""
    first = min(o["lines"][0][0] for o in outs)
    last = max(o["lines"][-1][0] for o in outs)
    n_tok = sum(len(o["tokens"]) for o in outs)
    return (n_tok - len(outs)) / max(last - first, 1e-9)


def dispatch_line(info0: dict, info: dict) -> str:
    """The engine's dispatch counters between two ``/get_server_info``
    reads: dispatches, graph replays, captures and their seconds, and the
    host ms per dispatch (queueing the replay or the eager body, and the
    copy of its outputs)."""
    d = {k: info[k] - info0[k] for k in (
        "decode_dispatches", "graph_replays", "graph_captures",
        "graph_capture_s", "decode_host_s")}
    n = max(d["decode_dispatches"], 1)
    return (f"{d['decode_dispatches']} dispatches, {d['graph_replays']} "
            f"replays, {d['graph_captures']} captures in "
            f"{d['graph_capture_s']:.2f} s, host ms per dispatch "
            f"{d['decode_host_s'] / n * 1e3:.3f} (captures included)")


# greedy logprobs of one stream at pipeline_depth 16 and 0, when the two
# runs admitted it in waves of another size or prompt bucket (another
# prefill batch shape may take another cuBLAS algorithm), in nats
RUNAHEAD_LP_TOL = 1e-3


def run_mix(port: int, bodies: list[dict], tag: str) -> tuple[list, dict, dict]:
    """The mix again from an empty prefix cache, with ``tag`` on every rid;
    returns the streams and the server info before and after."""
    post(port, "/flush_cache", {})
    info0 = post(port, "/get_server_info", None)
    outs = run_requests(port, [{**b, "rid": f"{b['rid']}-{tag}"} for b in bodies])
    return outs, info0, post(port, "/get_server_info", None)


def mix_wall_ms(outs: list[dict]) -> float:
    """From the first request's start to the last stream's last line."""
    return (max(o["lines"][-1][0] for o in outs)
            - min(o["t0"] for o in outs)) * 1e3


def runahead_against_sync(port: int, engine, bodies: list[dict],
                          outs: list[dict]) -> dict:
    """The mix's greedy streams with the engine running ahead (the main
    path, pipeline_depth 16) against the synchronous engine
    (pipeline_depth 0): the same token ids; logprobs bitwise where both
    runs admitted the stream in a wave of the same kind, size and prompt
    bucket, else within RUNAHEAD_LP_TOL. The mix at each depth in turns
    (16, 0, 0, 16) for decode tok/s and TTFT (a group-table shape the
    earlier runs did not meet is still captured; each line says so), then
    once more at depth 16 under torch.profiler for the device's busy share
    of the mix's wall."""
    depth = engine.pipeline_depth
    tok_s: dict = {depth: [], 0: []}
    sync = None
    try:
        for i, d in enumerate((depth, 0, 0, depth)):
            engine.pipeline_depth = d
            run, i0, i1 = run_mix(port, bodies, f"d{d}r{i}")
            tok_s[d].append(mix_tok_s(run))
            ttft = statistics.median(o["lines"][0][0] - o["t0"] for o in run)
            log(f"serve run-ahead: depth {d}: {tok_s[d][-1]:.1f} decode "
                f"tok/s, TTFT median {ttft * 1e3:.1f} ms; "
                + dispatch_line(i0, i1))
            if d == 0 and sync is None:
                sync, sync_tag = run, f"d{d}r{i}"
    finally:
        engine.pipeline_depth = depth
    waves = {rid: (kind, size, pb) for rid, kind, size, pb in engine.admissions}
    cases = []
    for b, a, o in zip(bodies, outs, sync):
        if b["sampling_params"]["temperature"] > 0:
            continue
        rid = b["rid"]
        check(a["tokens"] == o["tokens"],
              f"{rid}: depth {depth} and depth 0 gave other tokens")
        gap = float(np.abs(np.asarray(a["logprobs"])
                           - np.asarray(o["logprobs"])).max())
        w16, w0 = waves[rid], waves[f"{rid}-{sync_tag}"]
        same = w16 == w0
        cases.append(f"{rid}: admitted {w16} / {w0}, "
                     f"{'same waves: bitwise' if same else 'other waves'}, "
                     f"max |logprob diff| {gap:.2e}")
        check(gap == 0.0 if same else gap <= RUNAHEAD_LP_TOL,
              f"{rid}: depth {depth} against depth 0: {cases[-1]}")
    log("serve run-ahead: greedy streams, depth 16 (main path) against 0: "
        "same tokens; " + "; ".join(cases))
    res: dict = {}

    def profiled_mix():
        res["outs"], res["i0"], res["i1"] = run_mix(port, bodies, "busy")

    busy = device_profile(profiled_mix, 1)["device_ms"]
    wall = mix_wall_ms(res["outs"])
    med = {d: statistics.median(v) for d, v in tok_s.items()}
    log(f"serve run-ahead: decode tok/s median depth {depth} {med[depth]:.1f}, "
        f"depth 0 {med[0]:.1f} ({med[depth] / med[0]:.3f} x); the mix at "
        f"depth {depth} under torch.profiler: device busy {busy:.1f} ms of "
        f"{wall:.1f} ms wall ({busy / wall:.3f}); "
        + dispatch_line(res["i0"], res["i1"]))
    return dict(tok_s=med[depth], sync_tok_s=med[0], busy_share=busy / wall)


AB_STEPS = 50   # decode steps per route in the serve phase's A/B
PROF_STEPS = 5  # of them traced by torch.profiler, per route


def device_profile(fn, calls: int) -> dict:
    """Per call of ``fn``, from a torch.profiler trace of ``calls`` calls:
    the device's kernels, its memory copies and sets, and the device ms
    they took (the sum of their durations: busy time, not wall)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    n_mem = sum(e.name.startswith(("Memcpy", "Memset")) for e in on_dev)
    return dict(kernels=(len(on_dev) - n_mem) / calls, copies=n_mem / calls,
                device_ms=sum(e.device_time_total for e in on_dev) / 1e3 / calls)


def decode_ab(dev, params, cfg) -> dict:
    """The decode step's three routes at the serving tables
    (``serving_tables``: 64 slots, 18 live), on the served model's
    weights and pools of random K/V: the default (the fused prologue),
    ``kv_write_fn=pa.paged_kv_write`` (eager qk-norm and RoPE, then the
    standalone K1), and ``graph``: the fused route captured in a CUDA graph
    and replayed. Gates: one step of the first two from the same pools and
    inputs, the live slots' log-softmax within DECODE_AB_TOL nats; a replay
    bitwise the eager fused step. Then AB_STEPS ``forward_paged_decode``
    steps per route in turns (fused, unfused, graph, graph, unfused,
    fused), each synchronised and timed on the host's clock, at fixed
    lengths (every step writes the same positions: the same work as a real
    step), with each turn's launch counts zeroed just before it and read
    just after (a replay credits what its capture recorded); and
    PROF_STEPS more per route under torch.profiler for kernels and device
    ms per step. Returns the launches by route."""
    table, lens, _ = serving_tables(dev)
    active = lens > 0
    pools = decoder.make_paged_pools(cfg, int(table.max()) + 1, PS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for p_ in pools[0] + pools[1]:
        p_.normal_(generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (S,), generator=gen, device=dev)
    kv_write = {"fused": None, "unfused": pa.paged_kv_write}

    def step(route, pools_=pools):
        return decoder.forward_paged_decode(
            params, cfg, tokens, lens, pools_, table, lens, active=active,
            kv_write_fn=kv_write[route])[0]

    lsm = {}
    for route in kv_write:
        copy = ([p_.clone() for p_ in pools[0]], [p_.clone() for p_ in pools[1]])
        lsm[route] = torch.log_softmax(step(route, copy)[active], dim=-1)
        del copy
    gap = (lsm["fused"] - lsm["unfused"]).abs().max().item()
    agree = (lsm["fused"].argmax(-1) == lsm["unfused"].argmax(-1)).float().mean()
    log(f"serve decode a/b: fused vs unfused route from the same pools and "
        f"inputs: max |log-softmax diff| over the {int(active.sum())} live "
        f"slots' vocabulary {gap:.4f} nats (tolerance {DECODE_AB_TOL}), "
        f"argmax agreement {agree.item():.3f}")
    check(gap <= DECODE_AB_TOL, f"the fused decode route differs from the "
          f"unfused one by {gap:.4f} nats (limit {DECODE_AB_TOL})")
    del lsm

    # the graph route: the fused step captured once (after a warm-up on the
    # capturing stream), its launches recorded for crediting at each replay
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        eager_logits = step("fused").clone()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with cuda_build.recording_launches() as graph_launches:
        with torch.cuda.graph(graph, stream=side):
            graph_logits = step("fused")
    graph.replay()
    torch.cuda.synchronize()
    # live slots only: idle slots all write the null page and read it back,
    # racing one another
    check(torch.equal(graph_logits[active], eager_logits[active]),
          "a replay of the captured fused step differs from the eager step")

    def replay():
        graph.replay()
        cuda_build.credit_launches(graph_launches)

    routes = {"fused": lambda: step("fused"), "unfused": lambda: step("unfused"),
              "graph": replay}
    walls = {r: [] for r in routes}
    launches = {r: dict.fromkeys(cuda_build.LAUNCHES, 0) for r in routes}
    for route in ("fused", "unfused", "graph", "graph", "unfused", "fused"):
        cuda_build.reset_launch_counts()
        for _ in range(AB_STEPS // 2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            routes[route]()
            torch.cuda.synchronize()
            walls[route].append((time.monotonic() - t0) * 1e3)
        for k_, n in cuda_build.LAUNCHES.items():
            launches[route][k_] += n
    n_l = cfg.num_layers * AB_STEPS
    for route in ("fused", "graph"):
        check(launches[route]["paged_kv_write_fused"] == n_l
              and launches[route]["paged_kv_write"] == 0,
              f"the {route} route's launches: {launches[route]}")
    check(launches["unfused"]["paged_kv_write"] == n_l
          and launches["unfused"]["paged_kv_write_fused"] == 0,
          f"the unfused route's launches: {launches['unfused']}")
    prof = {r: device_profile(fn, PROF_STEPS) for r, fn in routes.items()}
    for route in routes:
        w = sorted(walls[route])
        pr = prof[route]
        log(f"serve decode a/b {route}: wall ms per step median "
            f"{statistics.median(w):.2f} (min {w[0]:.2f}, p90 "
            f"{w[int(0.9 * len(w))]:.2f}, max {w[-1]:.2f}; {len(w)} steps), "
            f"{int(active.sum()) / statistics.median(w) * 1e3:.1f} live tok/s; "
            f"device ms per step {pr['device_ms']:.3f}, kernels per step "
            f"{pr['kernels']:.1f} (+ {pr['copies']:.1f} copies/sets; torch."
            f"profiler over {PROF_STEPS} steps); launches "
            + json.dumps({k_: n for k_, n in launches[route].items() if n}))
    del graph
    return launches


# -- the engine's decode dispatch: graph against eager --------------------------

# a sampled token's logprob against the filtered log-softmax recomputed from
# the same state (the same kernels on the same inputs: equal but for the
# order of a reduction, if any)
SAMPLED_LOGP_TOL = 1e-5


def engine_snapshot(eng) -> tuple:
    """The engine's device state, pools and sampling generator state."""
    return ({n: t.clone() for n, t in eng._dev.items()},
            [[p_.clone() for p_ in side] for side in eng._pools],
            eng._gen.get_state())


def engine_restore(eng, snap: tuple, generator: bool = True) -> None:
    for n, t in snap[0].items():
        eng._dev[n].copy_(t)
    for side, saved in zip(eng._pools, snap[1]):
        for p_, s_ in zip(side, saved):
            p_.copy_(s_)
    if generator:
        eng._gen.set_state(snap[2])


def engine_outputs(eng) -> tuple:
    """The last dispatch's [k, S] outputs and the state it left."""
    torch.cuda.synchronize()
    return tuple(o.clone() for o in eng._out), engine_snapshot(eng)


def graph_against_eager(eng, use_filters: bool, tables) -> dict:
    """One k-step dispatch of the engine (not started) at its current
    state, replayed from the graph of its key (captured first when new:
    the warm-up runs the dispatch, then the state is put back), and the
    same dispatch by the eager body from the same snapshot of pools,
    device state and generator. Returns both runs' outputs and end states
    and the snapshot; the engine is left at the snapshot."""
    snap = engine_snapshot(eng)
    if eng._graph_key(use_filters, tables) not in eng._graphs:
        eng._launch_decode(use_filters, tables)
        engine_restore(eng, snap)
    eng._launch_decode(use_filters, tables)
    graph_out, graph_state = engine_outputs(eng)
    engine_restore(eng, snap)
    eng._decode_body(use_filters, eng._group_tables(tables))
    eager_out, eager_state = engine_outputs(eng)
    engine_restore(eng, snap)
    return dict(graph=graph_out, graph_state=graph_state, eager=eager_out,
                eager_state=eager_state, snap=snap)


def states_equal(a: tuple, b: tuple) -> bool:
    """Device state and pools bitwise equal, but for the null page 0, which
    every inactive slot writes and which only inactive slots read (their
    writes race one another)."""
    return (all(torch.equal(a[0][n], b[0][n]) for n in a[0])
            and all(torch.equal(x[:, 1:], y[:, 1:])
                    for sa, sb in zip(a[1], b[1]) for x, y in zip(sa, sb)))


def sampled_row_checks(eng, use_filters: bool, tables, run: dict) -> dict:
    """The graph's sampled rows against the engine's own sampler, stepping
    the eager forward through the dispatch from the snapshot with the
    graph's tokens fed back: each sampled token lies in its row's filtered
    set (top-k, top-p), and its logprob is the filtered, temperature-scaled
    log-softmax at that token. Returns the worst error and the counts."""
    from polyrl_tpu_torch.rollout import sampling

    engine_restore(eng, run["snap"])
    st, gt = eng._dev, eng._group_tables(tables)
    attn = None
    if gt is not None:
        def attn(q, kp, vp, pt, ln):
            return pa.grouped_paged_attention(q, kp, vp, pt, ln, *gt)
    tok, lp, done = run["graph"]
    seq, last = st["seq_lens"].clone(), st["last_tokens"].clone()
    active = st["active"].clone()
    err, n_rows, outside = 0.0, 0, 0
    for i in range(eng.steps_per_dispatch):
        logits, _ = decoder.forward_paged_decode(
            eng.params, eng.cfg, last, seq, eng._pools, st["page_table"], seq,
            attn_fn=attn, active=active)
        scaled = sampling._filtered_scaled(logits, st["temps"], st["top_ps"],
                                           st["top_ks"], use_filters)
        rows = active & (st["temps"] > 0)
        t = tok[i].long()[:, None]
        kept = scaled.gather(-1, t)[:, 0] > sampling.NEG_INF
        outside += int((rows & ~kept).sum())
        ref = torch.log_softmax(scaled, dim=-1).gather(-1, t)[:, 0]
        if rows.any():
            err = max(err, (ref - lp[i])[rows].abs().max().item())
        n_rows += int(rows.sum())
        seq = seq + active.int()
        last = torch.where(active, tok[i], last)
        active = active & ~done[i]
    engine_restore(eng, run["snap"])
    return dict(err=err, rows=n_rows, outside=outside)


def profiled_port_kernels(fn, calls: int) -> dict:
    """Kernels of the port's own libraries in a torch.profiler trace of
    ``calls`` calls of ``fn``, by kernel name (the identifier before any
    template arguments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = {r["kernel"].split("<")[0] for lib in cuda_build.KERNELS
             if cuda_build.lib_path(lib).exists()
             for r in cuda_build.ptxas_report(lib)}
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    counts: dict = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        for n in names:
            if re.search(rf"\b{n}\b", e.name):
                counts[n] = counts.get(n, 0) + 1
    return counts


def engine_graph_checks(dev, params, cfg) -> dict:
    """The engine's k-step decode dispatch (``rollout/cb_engine.py``) as a
    CUDA graph against its eager body, at the serving tables: an engine on
    the served weights (not started: driven through its internals) admits
    the serve mix -- a greedy GRPO group of 8, a sampled one (temperature
    1, top-p 0.9, top-k 50: filters on) and two greedy requests -- and
    takes one dispatch. Then for the ungrouped key (K2) and the grouped
    key (K3), each with filters on: a replay and the eager body from the
    same snapshot give bitwise equal tokens, logprobs, done flags, device
    state and pools; the sampled rows pass ``sampled_row_checks``; two
    replays from the same generator state give the same tokens, and a
    replay after another draws different ones. Each dispatch eager
    against replayed, synchronised, on the host's clock; the replay also
    by CUDA events. Launch credit: over a few replays under
    torch.profiler, the profiler's count of the port's kernels equals
    what ``LAUNCHES`` was credited."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                   num_pages=128, steps_per_dispatch=8, seed=3, device=dev)
    rng = np.random.default_rng(5)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=64)
    sampled = SamplingParams(temperature=1.0, top_p=0.9, top_k=50,
                             max_new_tokens=64)
    for g, (n_p, sp) in enumerate(((200, greedy), (203, sampled))):
        prompt = rng.integers(1, cfg.vocab_size, n_p).tolist()
        for i in range(8):
            eng.submit(f"g{g}-{i}", prompt, sp, group_id=f"grp{g}",
                       group_size=8)
    for i, n_p in enumerate((198, 205)):
        eng.submit(f"greedy{i}", rng.integers(1, cfg.vocab_size, n_p).tolist(),
                   greedy)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()  # mid-decode; captures the grouped key
        eng._drain_emit_q()
    tables = eng._decode_group_pack()
    check(tables is not None and int(eng._active.sum()) == 18,
          f"{int(eng._active.sum())} active slots, groups {tables is not None}")
    out = {}
    for label, tb in (("ungrouped (K2)", None), ("grouped (K3)", tables)):
        key = eng._graph_key(True, tb)
        run = graph_against_eager(eng, True, tb)
        same = [torch.equal(a, b) for a, b in zip(run["graph"], run["eager"])]
        pools_same = states_equal(run["graph_state"], run["eager_state"])
        check(all(same) and pools_same,
              f"{label}: the replayed dispatch differs from the eager body "
              f"(tokens/logprobs/done equal {same}, state and pools equal "
              f"{pools_same})")
        rows = sampled_row_checks(eng, True, tb, run)
        check(rows["rows"] > 0 and rows["outside"] == 0
              and rows["err"] <= SAMPLED_LOGP_TOL,
              f"{label}: sampled rows: {json.dumps(rows)}")
        # two replays from the same generator state, then one after another
        eng._launch_decode(True, tb)
        again, _ = engine_outputs(eng)
        engine_restore(eng, run["snap"], generator=False)
        eng._launch_decode(True, tb)
        later, _ = engine_outputs(eng)
        sampled_rows = (run["snap"][0]["active"]
                        & (run["snap"][0]["temps"] > 0))
        n_diff = int((later[0] != run["graph"][0])[:, sampled_rows].sum())
        check(torch.equal(again[0], run["graph"][0]),
              f"{label}: two replays from one generator state differ")
        check(n_diff > 0, f"{label}: a later replay drew the same tokens")
        # timing: eager body against replay, state put back before each
        walls = {"eager": [], "graph": []}
        dev_ms = []
        for route in ("eager", "graph", "graph", "eager"):
            for _ in range(3):
                engine_restore(eng, run["snap"])
                torch.cuda.synchronize()
                t0 = time.monotonic()
                if route == "eager":
                    eng._decode_body(True, eng._group_tables(tb))
                else:
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    eng._launch_decode(True, tb)
                    b.record()
                torch.cuda.synchronize()
                walls[route].append((time.monotonic() - t0) * 1e3)
                if route == "graph":
                    dev_ms.append(a.elapsed_time(b))
        k = eng.steps_per_dispatch
        med = {r: statistics.median(w) for r, w in walls.items()}
        log(f"serve graph vs eager {label}: key {key}: {k}-step dispatch "
            f"replayed bitwise the eager body (tokens, logprobs, done, state, "
            f"pools); sampled rows {rows['rows']} in their filtered sets, "
            f"max |logprob - filtered log-softmax| {rows['err']:.2e} "
            f"(tolerance {SAMPLED_LOGP_TOL}); same generator state, same "
            f"tokens; next replay {n_diff} sampled tokens other; wall ms per "
            f"dispatch eager {med['eager']:.2f}, replay {med['graph']:.2f} "
            f"({med['eager'] / k:.2f} / {med['graph'] / k:.2f} per step), "
            f"replay device ms {statistics.median(dev_ms):.3f} (CUDA events)")
        engine_restore(eng, run["snap"])
        out[label] = med

    # a capture while another thread works the card (allocations, products,
    # host reads), as the pipelined trainer's does: thread-local capture.
    # Its draws come from a generator of its own: every capture registers
    # the default CUDA generator, which then refuses draws outside it
    busy_stop = threading.Event()
    n_busy = [0]
    busy_gen = torch.Generator(device=dev).manual_seed(1)

    def busy_thread():
        while not busy_stop.is_set():
            a = torch.randn((1024, 1024), device=dev, generator=busy_gen)
            n_busy[0] += int((a @ a).abs().sum().item() > 0)

    worker = threading.Thread(target=busy_thread, daemon=True)
    worker.start()
    try:
        n_before = len(eng._graphs)
        run = graph_against_eager(eng, False, tables)
    finally:
        busy_stop.set()
        worker.join(timeout=60)
    check(not worker.is_alive() and n_busy[0] > 0
          and len(eng._graphs) == n_before + 1, "no capture beside the busy thread")
    check(all(torch.equal(a, b) for a, b in zip(run["graph"], run["eager"]))
          and states_equal(run["graph_state"], run["eager_state"]),
          "a graph captured beside another thread's work differs from the eager body")
    log(f"serve graph vs eager: key {eng._graph_key(False, tables)} captured "
        f"while another thread ran {n_busy[0]} products with allocations and "
        f"host reads: replay bitwise the eager body; {engine_line(eng)}")

    # launch credit: the profiler's count of the port's kernels over a few
    # replays against what LAUNCHES was credited
    replays = 3

    def replay_grouped():
        engine_restore(eng, run["snap"])
        eng._launch_decode(True, tables)

    cuda_build.reset_launch_counts()
    seen = profiled_port_kernels(replay_grouped, replays)
    credited = dict(cuda_build.LAUNCHES)
    split = sum(n for name, n in seen.items() if name.startswith("paged_split"))
    want = {"paged_kv_write_fused_kernel": credited["paged_kv_write_fused"],
            "paged_split": credited["paged_attention"]
            + credited["grouped_paged_attention"],
            "paged_combine_kernel": credited["paged_attention"]
            + credited["grouped_paged_attention"]}
    got = {"paged_kv_write_fused_kernel": seen.get("paged_kv_write_fused_kernel", 0),
           "paged_split": split,
           "paged_combine_kernel": seen.get("paged_combine_kernel", 0)}
    log(f"serve launch credit: {replays} replays of the grouped key: "
        f"torch.profiler counted {json.dumps(seen)}; LAUNCHES credited "
        f"{json.dumps({k_: n for k_, n in credited.items() if n})}")
    check(got == want and credited["paged_kv_write_fused"]
          == replays * eng.steps_per_dispatch * cfg.num_layers,
          f"launch credit disagrees with the profiler: {got} against {want}")
    cuda_build.reset_launch_counts()
    del eng
    return out


@contextlib.contextmanager
def missing_last_page(engine):
    """Within the block the engine's decode attention runs K2/K3 with each
    slot's length cut back past its last page (a page-table fault that
    loses up to 64 recent tokens). The kernels still launch. The engine's
    graphs are dropped on the way in and out, so that its dispatches are
    captured again with the fault and then without it."""
    from polyrl_tpu_torch.rollout import cb_engine

    def cut(lens):
        return torch.clamp(lens - ((lens - 1) % PS + 1), min=0)

    k2, k3 = decoder.paged_attention, cb_engine.grouped_paged_attention
    decoder.paged_attention = lambda q, kp, vp, pt, lens, *a: k2(
        q, kp, vp, pt, cut(lens), *a)
    cb_engine.grouped_paged_attention = lambda q, kp, vp, pt, lens, *a: k3(
        q, kp, vp, pt, cut(lens), *a)
    engine._graphs.clear()
    try:
        yield
    finally:
        decoder.paged_attention, cb_engine.grouped_paged_attention = k2, k3
        engine._graphs.clear()


# -- phase 4: two GRPO steps through the trainer's entry point ------------------


TRAIN_OVERRIDES = [
    "device=cuda", f"model.preset={MODEL}", "model.dtype=bfloat16",
    "tokenizer.kind=byte", "data.train_path=arithmetic",
    "rollout.max_slots=64", "rollout.page_size=64", "rollout.num_pages=512",
    "rollout.max_seq_len=512", "rollout.prompt_buckets=64",
    "trainer.train_batch_size=2", "trainer.rollout_n=8",
    "trainer.ppo_mini_batch_size=16", "trainer.micro_batch_size=4",
    "trainer.min_stream_batch_size=16", "trainer.max_prompt_length=64",
    "trainer.max_response_length=448", "trainer.adv_estimator=grpo",
    "trainer.total_steps=2", "trainer.temperature=1.0", "trainer.seed=0",
    # lr 1e-4: Adam's first step moves a weight by about lr, and a bf16
    # weight of 0.02 only moves when that exceeds half an ulp (6e-5)
    "actor.use_kl_loss=true", "actor.remat=true", "actor.lr=1e-4",
    "reward.num_workers=1",
]


def cut_depth(layers: int) -> str:
    return "model.overrides=" + json.dumps({"num_layers": layers})


# the disagg, hybrid, lora_delta and autoscale phases run the training cell
# at full width and this depth, trainers and servers alike: their pushes,
# joins, drains, bubbles, salvage and goodput split hold at any depth, and
# at 28 layers the four took 343-416 s of the smoke's 1,200 s (NVIDIA H100
# 80GB HBM3 at 700.00 W)
REMOTE_CUT_LAYERS = 4
REMOTE_OVERRIDES = TRAIN_OVERRIDES + [cut_depth(REMOTE_CUT_LAYERS)]
# step-1 old logprobs (trainer forward, K4) against the engine's sampling
# logprobs (paged decode, K1/K2), in nats over every response token: both
# run the same bf16 weights through other kernels and another bf16
# rounding order; the limit is about twice the largest gap measured on the
# card (0.105 nats over 7,168 tokens)
LOGP_AGREE_TOL = 0.2
# the flattened full-model gradient of one micro, K4 against the plain
# attention: on an f32 copy of the weights the kernel alone shows (cosine
# 1.000000 measured); on the bf16 weights both attentions' 1-ulp roundings
# compound through 28 random-init layers, so its limit sits between the
# two (H100, six seeds: 0.9987; the tile-local fault about 0.01). The micro
# is step 1's, read on step 1's weights: read after the fit instead, two
# updates stale, 78-82% of its tokens sit in the PPO clip and a one-ulp
# change of the attention output moves a few across a clip edge, which
# switches their policy-gradient term (3-9 of 1,792 tokens, cosine
# 0.973-0.993; with the clips off 0.9996)
GRAD_COS_MIN = 0.99
GRAD_COS_MIN_BF16 = 0.98
GRAD_NORM_RATIO_TOL = 0.02


def byte_length_score(data_source, text, ground_truth, extra_info) -> float:
    """A reward that varies within a GRPO group at random weights: the
    response's UTF-8 length (about 1 byte in 448 random tokens at vocab
    151,936), so the group-relative advantages are not all 0."""
    return float(len(text.encode("utf-8")))


def tile_local_attention(q, k, v, attn_mask):
    """K4 fed wrong segment ids, a planted fault for the train gates: every
    real token's segment is its 64-row tile, so each query loses the keys
    of all earlier tiles (the kernel still launches)."""
    t = attn_mask.shape[1]
    tile = torch.arange(t, device=attn_mask.device) // 64 + 1
    seg = (attn_mask.to(torch.int32) * tile[None].to(torch.int32)).contiguous()
    return flash.flash_attention_train(q, k, v, attn_mask, segment_ids=seg)


def _leaves(tree: dict, prefix: str = ""):
    for key, val in sorted(tree.items()):
        if isinstance(val, dict):
            yield from _leaves(val, prefix + key + ".")
        else:
            yield prefix + key, val


@contextlib.contextmanager
def launches_apart(store: dict, names=None):
    """Run gate-only work without adding to the main path's counts: its
    launches of ``names`` (every kernel by default) go to ``store``. Name
    only the kernels the gate launches where another thread of the main
    path may launch others meanwhile."""
    names = tuple(cuda_build.LAUNCHES) if names is None else names
    before = {k_: cuda_build.LAUNCHES[k_] for k_ in names}
    try:
        yield
    finally:
        for k_ in names:
            store[k_] = store.get(k_, 0) + cuda_build.LAUNCHES[k_] - before[k_]
            cuda_build.LAUNCHES[k_] = before[k_]


def micro_loss_grads(actor, feed, attn_fn) -> list[torch.Tensor]:
    """The full-model gradient of the actor's loss on one micro with
    ``attn_fn`` as every layer's attention (the parameters are left as
    they are)."""
    keep = actor.attn_fn
    actor.attn_fn = attn_fn
    try:
        for _, p in _leaves(actor.params):
            p.grad = None
        with torch.enable_grad():
            loss, _ = actor._loss_fn(feed, 1.0)
            loss.backward()
        grads = [p.grad for _, p in _leaves(actor.params)]
        for _, p in _leaves(actor.params):
            p.grad = None
        return grads
    finally:
        actor.attn_fn = keep


def _tree_map(fn, tree: dict) -> dict:
    return {k_: (_tree_map(fn, v) if isinstance(v, dict) else fn(v))
            for k_, v in tree.items()}


@contextlib.contextmanager
def params_swapped(actor, params: dict):
    """Within the block the actor computes with ``params`` (a tree of
    autograd leaves); its own come back after."""
    keep = actor.params
    actor.params = params
    try:
        yield
    finally:
        actor.params = keep


def host_copy(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def step1_weights(host: dict, dev) -> dict:
    """A host snapshot of the actor's weights back on ``dev`` as leaves."""
    return _tree_map(lambda t: t.to(dev).requires_grad_(True), host)


def _tree_map_f32(tree: dict) -> dict:
    """An f32 copy of a parameter tree, as autograd leaves."""
    return {k_: (_tree_map_f32(v) if isinstance(v, dict)
                 else v.detach().float().requires_grad_(True))
            for k_, v in tree.items()}


def grad_agreement(ga, gb) -> tuple[float, float]:
    """Cosine of the flattened gradients and the ratio of their norms."""
    dot = sum(torch.sum(a.float() * b.float()) for a, b in zip(ga, gb)).item()
    na = sum(torch.sum(a.float() ** 2) for a in ga).item() ** 0.5
    nb = sum(torch.sum(b.float() ** 2) for b in gb).item() ** 0.5
    return dot / (na * nb), na / nb


def gradient_readings(actor, micro) -> tuple[float, float, float, float]:
    """The micro's full-model gradient through K4, and through K4 fed
    tile-local segment ids, each against the same through the plain
    attention, on the actor's current parameters: (cosine, norm ratio) of
    K4, then of the fault."""
    g_plain = micro_loss_grads(actor, micro, plain_attention)
    g = micro_loss_grads(actor, micro, flash.auto_train_attention())
    cos, ratio = grad_agreement(g, g_plain)
    del g
    g = micro_loss_grads(actor, micro, tile_local_attention)
    bad_cos, bad_ratio = grad_agreement(g, g_plain)
    del g, g_plain
    return cos, ratio, bad_cos, bad_ratio


def gate_micro(feed: dict, dev) -> dict:
    """The gradient gate's micro: the 4 rows of step 1 with the largest
    positive advantages (same-sign terms: no cancellation in the policy
    gradient), on ``dev``."""
    from polyrl_tpu_torch.trainer.actor import _to_device

    rows = np.argsort(-feed["advantages"].sum(-1))[:4]
    return _to_device({k_: v[rows] for k_, v in feed.items()
                       if k_ != "rollout_log_probs"}, dev)


def both_precisions(actor, micro) -> dict:
    """``gradient_readings`` on the actor's bf16 weights and on an f32
    copy of them: {"bf16": readings, "f32": readings}."""
    out = {"bf16": gradient_readings(actor, micro)}
    with params_swapped(actor, _tree_map_f32(actor.params)):
        out["f32"] = gradient_readings(actor, micro)
    return out


def gradient_gate(readings: tuple, cos_min: float, label: str) -> str:
    """K4's ``gradient_readings`` must pass (cosine >= ``cos_min``, norm
    ratio within GRAD_NORM_RATIO_TOL) and the fault's must fail. Returns
    the log line's readings."""
    cos, ratio, bad_cos, bad_ratio = readings
    check(cos >= cos_min and abs(ratio - 1) <= GRAD_NORM_RATIO_TOL,
          f"K4 gradient on {label} weights disagrees with the plain "
          f"attention's (cosine {cos:.6f}, norm ratio {ratio:.5f})")
    check(bad_cos < cos_min or abs(bad_ratio - 1) > GRAD_NORM_RATIO_TOL,
          f"the gradient gate on {label} weights passes tile-local segment ids")
    return (f"{label} weights: cosine {cos:.6f}, norm ratio {ratio:.5f} "
            f"(limits >= {cos_min}, within {GRAD_NORM_RATIO_TOL}); with "
            f"tile-local segment ids: cosine {bad_cos:.4f}, norm ratio "
            f"{bad_ratio:.4f} (fails)")


def plain_attention(q, k, v, attn_mask):
    return flash.flash_attention_train_ref(q, k, v, attn_mask)


# every step record's goodput split must explain its wall to within 5%
ATTRIBUTED_FRAC = (0.95, 1.05)
GOODPUT_PHASES = ("generate", "bubble", "process", "update", "weight_push",
                  "salvage_resume", "manager_rtt", "housekeeping", "other")
TRAINING_KEYS = ("training/entropy", "training/approx_kl",
                 "training/degenerate_group_frac",
                 "training/effective_batch_frac", "training/adv_abs/p50",
                 "training/response_len/max", "training/staleness_known_frac")
STATUSZ_POLL_S = 0.5


def plane_gates(history: list[dict], label: str,
                smoke_s: list[float] | None = None,
                ) -> None:
    """Every step record carries the goodput split and the health
    ledger's ``training/*`` keys, with ``attributed_frac`` in
    ATTRIBUTED_FRAC. ``smoke_s`` is, per step,
    the wall this script's own gates spent inside the step (a wrapper's
    extra forward and host copies), which no trainer phase can hold: it
    counts as attributed."""
    lo, hi = ATTRIBUTED_FRAC
    for i, rec in enumerate(history, 1):
        missing = [k_ for k_ in ([f"goodput/{p_}_s" for p_ in GOODPUT_PHASES]
                                 + ["goodput/step_wall_s", "goodput/mfu"]
                                 + list(TRAINING_KEYS)) if k_ not in rec]
        check(not missing, f"{label} step {i}: record lacks {missing}")
        extra = smoke_s[i - 1] if smoke_s else 0.0
        frac = (rec["goodput/attributed_frac"]
                + extra / rec["goodput/step_wall_s"])
        check(lo <= frac <= hi, f"{label} step {i}: goodput/attributed_frac "
              f"{frac:.4f} (with {extra:.3f} s of the smoke's own gates) "
              f"outside {ATTRIBUTED_FRAC}: {goodput_split(rec)}")


def goodput_split(rec: dict) -> str:
    return (", ".join(f"{p_} {rec[f'goodput/{p_}_s']:.2f}" for p_ in GOODPUT_PHASES
                      if rec[f"goodput/{p_}_s"] >= 0.005)
            + f" of {rec['goodput/step_wall_s']:.2f} s (attributed "
            f"{rec['goodput/attributed_frac']:.4f}, mfu {rec['goodput/mfu']:.4f})")


def plane_timers(trainer) -> list[float]:
    """Host ms a step of the goodput and health planes (``account``,
    ``observe_ibatch`` and ``finalize_step``, wrapped on the instances):
    one entry per finished step."""
    acc = [0.0]
    steps: list[float] = []
    health, ledger = trainer._health, trainer._goodput

    def timed(fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                acc[0] += time.perf_counter() - t0
        return run

    health.observe_ibatch = timed(health.observe_ibatch)
    ledger.account = timed(ledger.account)
    finalize = timed(health.finalize_step)

    def finalize_step(step, metrics=None):
        out = finalize(step, metrics)
        steps.append(acc[0] * 1e3)
        acc[0] = 0.0
        return out

    health.finalize_step = finalize_step
    return steps


def statusz_poller(endpoint: str) -> tuple:
    """Poll ``/statusz`` on its own thread every STATUSZ_POLL_S; returns
    (stop event, snapshots, errors, thread)."""
    import urllib.request

    stop, snaps, errs = threading.Event(), [], []

    def run():
        try:
            while not stop.is_set():
                with urllib.request.urlopen(f"http://{endpoint}/statusz",
                                            timeout=30) as r:
                    snaps.append(json.loads(r.read()))
                stop.wait(STATUSZ_POLL_S)
        except BaseException as exc:  # noqa: BLE001 -- checked by the caller
            errs.append(exc)

    t = threading.Thread(target=run, name="statusz-poll", daemon=True)
    t.start()
    return stop, snaps, errs, t


def train_phase(dev) -> dict:
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.obs import statusz
    from polyrl_tpu_torch.obs.recorder import MEMORY_SNAPSHOT
    from polyrl_tpu_torch.train import build_trainer

    run_dir = tempfile.mkdtemp(prefix="train-obs-")
    cfg = load_config(None, TRAIN_OVERRIDES + [
        "obs.statusz=true", "obs.recorder=true",
        "logging.backends=[console,jsonl]",
        f"logging.path={run_dir}/metrics.jsonl"])
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor, engine = trainer.actor, trainer.rollout
        log(f"train: {MODEL} trainer up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        gate_launches: dict = {}
        step1: dict = {}
        process = trainer._process_ibatch

        def first_ibatch_gates(ibatch, metrics):
            """Step 1, after the old/ref passes and before any update: the
            logprob agreement and its planted fault, on the weights the
            engine sampled with."""
            out = process(ibatch, metrics)
            if step1:
                return out
            t_gate = time.monotonic()
            mask = np.asarray(out["response_mask"]) > 0
            gap = np.abs(np.asarray(out["old_log_probs"])
                         - np.asarray(out["rollout_log_probs"]))[mask]
            feed = {k_: np.array(out[k_]) for k_ in (
                "input_ids", "positions", "attention_mask", "responses",
                "response_mask", "advantages", "old_log_probs",
                "ref_log_probs", "rollout_log_probs")}
            with launches_apart(gate_launches):
                keep = actor.attn_fn
                actor.attn_fn = tile_local_attention
                try:
                    bad_lp, _ = actor.compute_log_prob(feed, compute_entropy=False)
                finally:
                    actor.attn_fn = keep
            bad_gap = np.abs(bad_lp.float().cpu().numpy()
                             - feed["rollout_log_probs"])[mask]
            step1.update(feed=feed, gap_max=float(gap.max()),
                         gap_mean=float(gap.mean()), bad_max=float(bad_gap.max()),
                         bad_mean=float(bad_gap.mean()), tokens=int(mask.sum()),
                         weights=_tree_map(host_copy, actor.params))
            step1["gate_s"] = time.monotonic() - t_gate
            return out

        trainer._process_ibatch = first_ibatch_gates
        plane_ms = plane_timers(trainer)
        stop_poll, snaps, poll_errs, poller = statusz_poller(
            trainer._statusz.endpoint)
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        try:
            history = trainer.fit()
        finally:
            stop_poll.set()
            poller.join(timeout=60)
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        trainer._process_ibatch = process

        # gates on the run itself
        check(len(history) == 2, "the fit did not run 2 steps")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0, f"step {i}: zero gradient")
            check(rec["actor/nonfinite_skips"] == 0,
                  f"step {i}: a non-finite update was skipped")
        check(engine.weight_version == 3,
              f"weight_version {engine.weight_version} after 2 steps, not 3")
        for (name, a), (_, e) in zip(_leaves(actor.params), _leaves(engine.params)):
            check(torch.equal(a.detach(), e),
                  f"the engine's {name} differs from the actor's after the push")
        for name in TRAIN_KERNELS:
            check(launches[name] > 0, f"{name} was not launched in the train phase")
        # the observability planes: the goodput and health keys in every
        # record; /statusz answered during the fit; a healthy fit dumps no
        # bundle, a manual dump carries the CUDA memory snapshot
        plane_gates(history, "train", [step1["gate_s"], 0.0])
        check(not poll_errs, f"train: polling /statusz failed: {poll_errs}")
        mid = [s_ for s_ in snaps if s_["step"] and s_["goodput"].get("steps")]
        check(mid and all(all(k_ in s_ for k_ in statusz.REQUIRED_SECTIONS)
                          for s_ in snaps)
              and mid[0]["training"]["steps"] >= 1
              and mid[0]["schema"] == statusz.SCHEMA,
              f"train: /statusz during the fit: {len(snaps)} snapshots, "
              f"{len(mid)} after a step")
        final_snap = trainer.statusz_snapshot()
        check(final_snap["goodput"]["steps"] == 2
              and final_snap["training"]["steps"] == 2,
              "train: /statusz after the fit does not count 2 steps")
        rec_ = trainer._recorder
        check(not rec_.bundle_paths and rec_.anomalies == 0,
              f"train: a healthy fit dumped bundles {rec_.bundle_paths}")
        bundle = rec_.dump("manual")
        check(bundle is not None and os.path.isfile(
            os.path.join(bundle, MEMORY_SNAPSHOT)),
              "train: the manual bundle has no CUDA memory snapshot")
        with open(f"{run_dir}/metrics.jsonl") as f:
            logged = [json.loads(x) for x in f]
        check(len(logged) == 2 and logged[-1]["obs/log_errors"] == 0,
              "train: the jsonl logger missed records or counted errors")
        moved = sum(int((a.detach() != r).sum()) for (_, a), (_, r) in
                    zip(_leaves(actor.params), _leaves(trainer.ref_policy.params)))
        n_params = sum(p.numel() for _, p in _leaves(actor.params))

        # logprob agreement on step 1, and its planted fault
        log(f"train: step-1 old logprobs (K4) vs the engine's rollout logprobs "
            f"over {step1['tokens']} response tokens: max {step1['gap_max']:.4f}, "
            f"mean {step1['gap_mean']:.5f} nats (tolerance {LOGP_AGREE_TOL}); "
            f"with tile-local segment ids: max {step1['bad_max']:.4f}, mean "
            f"{step1['bad_mean']:.4f} (must fail)")
        check(step1["gap_max"] <= LOGP_AGREE_TOL,
              f"old logprobs disagree with the engine's ({step1['gap_max']:.4f} "
              f"nats > {LOGP_AGREE_TOL})")
        check(step1["bad_max"] > LOGP_AGREE_TOL,
              "the logprob gate passes tile-local segment ids")

        # gradient gate: one micro of step 1, K4 against the plain
        # attention, on the weights step 1's old logprobs came from (its
        # update's own gradient; after the fit the micro is two updates
        # stale, most of its tokens sit in the PPO clip, and a one-ulp
        # change of the forward moves some across a clip edge: see
        # GRAD_COS_MIN), gated in bf16 (the kernel instance the main path
        # runs) and on an f32 copy (where the comparison sees the kernel's
        # error alone)
        micro = gate_micro(step1["feed"], dev)
        with launches_apart(gate_launches), params_swapped(
                actor, step1_weights(step1.pop("weights"), dev)):
            readings = both_precisions(actor, micro)
        bf16_line = gradient_gate(readings["bf16"], GRAD_COS_MIN_BF16, "bf16")
        f32_line = gradient_gate(readings["f32"], GRAD_COS_MIN, "f32")
        log(f"train: micro gradient at step 1's weights, K4 vs plain attention "
            f"on {f32_line}; on the {bf16_line}")

        for i, rec in enumerate(history, 1):
            log(f"train: step {i}: wall {rec['perf/step_time_s']:.2f} s; "
                + ", ".join(f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
                    "gen", "reward", "old_log_prob", "ref_log_prob", "adv",
                    "update_actor", "update_weight"))
                + f"; tokens/s {rec['perf/throughput_tokens_per_s']:.1f}, mfu "
                f"{rec['perf/mfu']:.5f}, pg_loss {rec['actor/pg_loss']:.5f}, "
                f"kl_loss {rec['actor/kl_loss']:.3g}, grad_norm "
                f"{rec['actor/grad_norm']:.4f}, reward/mean {rec['reward/mean']:.3f}")
        log("train: " + engine_line(engine))
        for i, rec in enumerate(history, 1):
            log(f"train: step {i} goodput: {goodput_split(rec)}"
                + (f" (the smoke's step-1 gates {step1['gate_s']:.2f} s)"
                   if i == 1 else "") + "; training/ "
                f"entropy {rec['training/entropy']:.4f}, degenerate groups "
                f"{rec['training/degenerate_group_frac']:.3f}; the planes' "
                f"host ms {plane_ms[i - 1]:.3f}")
        log(f"train: /statusz polled {len(snaps)} times during the fit "
            f"({len(mid)} after step 1; sections {sorted(snaps[-1])}); the "
            f"manual bundle {sorted(os.listdir(bundle))}, memory snapshot "
            f"{os.path.getsize(os.path.join(bundle, MEMORY_SNAPSHOT)) / 1e6:.2f} MB")
        log(f"train: fit wall {fit_wall:.1f} s; peak memory {peak_gb:.2f} GB "
            f"(torch.cuda.max_memory_allocated); {moved} of {n_params} weights "
            f"moved from the reference copy; main-path launches "
            f"{json.dumps(launches)}; the gates' own launches "
            f"{json.dumps(gate_launches)}")
        return dict(launches=launches, history=history, peak_gb=peak_gb,
                    decode_dispatches=engine.decode_dispatches,
                    plane_ms=plane_ms)
    finally:
        for fn in reversed(cleanup):
            fn()
        shutil.rmtree(run_dir, ignore_errors=True)


def engine_line(engine) -> str:
    """The colocated engine's dispatch counters over its life."""
    n = max(engine.decode_dispatches, 1)
    return (f"engine (pipeline_depth {engine.pipeline_depth}): "
            f"{engine.decode_dispatches} decode dispatches, "
            f"{engine.graph_replays} graph replays, {engine.graph_captures} "
            f"captures in {engine.graph_capture_s:.2f} s (keys "
            f"{sorted(map(str, engine._graphs))}), host ms per dispatch "
            f"{engine.decode_host_s / n * 1e3:.3f} (captures included)")


class WrittenOutAttention(torch.autograd.Function):
    """The plain attention (f32 logits, softmax and products on bf16
    inputs, the output rounded once) with its backward written out, so
    that the softmax backward's delta = rowsum(dO * O) can be taken from
    the output as returned (``rounded``: bf16, the semantics of K4 and of
    the TPU kernel) or from the f32 output before rounding (what autograd
    through the plain attention computes, up to summation order). A probe
    of the gradient gate, never on a main path."""

    @staticmethod
    def forward(ctx, q, k, v, attn_mask, rounded: bool):
        b, t, hq, d = q.shape
        seg = attn_mask.to(torch.int32)
        mask = ((seg[:, :, None] == seg[:, None, :])
                & torch.ones((t, t), dtype=torch.bool, device=q.device).tril())
        p, o32 = WrittenOutAttention._probs_out(q, k, v, mask)
        out = o32.reshape(b, t, hq, d).to(q.dtype)
        ctx.save_for_backward(q, k, v, mask, out if rounded else o32)
        return out

    @staticmethod
    def _probs_out(q, k, v, mask):
        b, t, hq, d = q.shape
        hkv = k.shape[2]
        qg = q.reshape(b, t, hkv, hq // hkv, d).float()
        logits = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * d ** -0.5
        logits = torch.where(mask[:, None, None], logits, flash.MASK_VALUE)
        p = torch.softmax(logits, dim=-1)
        return p, torch.einsum("bhrqk,bkhd->bqhrd", p, v.float())

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mask, o = ctx.saved_tensors
        b, t, hq, d = q.shape
        hkv = k.shape[2]
        p, _ = WrittenOutAttention._probs_out(q, k, v, mask)
        do = dout.reshape(b, t, hkv, hq // hkv, d).float()
        delta = (do * o.reshape(do.shape).float()).sum(-1)  # [b, q, h, r]
        dp = torch.einsum("bqhrd,bkhd->bhrqk", do, v.float())
        ds = p * (dp - delta.permute(0, 2, 3, 1)[..., None]) * d ** -0.5
        qg = q.reshape(b, t, hkv, hq // hkv, d).float()
        dq = torch.einsum("bhrqk,bkhd->bqhrd", ds, k.float()).reshape(q.shape)
        dk = torch.einsum("bhrqk,bqhrd->bkhd", ds, qg)
        dv = torch.einsum("bhrqk,bqhrd->bkhd", p, do)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def written_out_attention(rounded: bool):
    return lambda q, k, v, attn_mask: WrittenOutAttention.apply(
        q, k, v, attn_mask, rounded)


def clip_branch(actor, micro, attn_fn):
    """Per response token of ``micro``, the branch its PPO loss term takes
    at the actor's weights with ``attn_fn``: 0 the ratio itself, 1 the
    clipped ratio, 2 the dual clip (vanilla loss, ``core_algos``); and the
    ratio."""
    keep = actor.attn_fn
    actor.attn_fn = attn_fn
    try:
        lp, _ = actor.compute_log_prob(micro, compute_entropy=False)
    finally:
        actor.attn_fn = keep
    c = actor.cfg
    lo = c.clip_ratio_low if c.clip_ratio_low is not None else c.clip_ratio
    hi = c.clip_ratio_high if c.clip_ratio_high is not None else c.clip_ratio
    adv = micro["advantages"]
    ratio = torch.exp(torch.clamp(lp.float() - micro["old_log_probs"], -20.0, 20.0))
    l1, l2 = -adv * ratio, -adv * torch.clamp(ratio, 1.0 - lo, 1.0 + hi)
    branch = (l2 > l1).int()
    dual = (adv < 0) & (torch.maximum(l1, l2) > -adv * c.clip_ratio_c)
    return torch.where(dual, 2, branch), ratio


def grad_gate_probes(actor, micro) -> dict:
    """On the bf16 weights, the cosine of the micro's full-model gradient
    between pairs of attentions: K4 and the plain attention (the gate);
    the plain attention and its written-out backward with delta from the
    f32 output (summation order alone: the bf16 model's noise floor) and
    from the bf16 output (K4's delta semantics); K4 and the latter; K4
    and the plain attention with the PPO clips switched off (a smooth
    loss). Also the response tokens whose clip branch differs between K4
    and the plain attention, and those within 1e-3 of a clip edge."""
    g = {name: micro_loss_grads(actor, micro, fn) for name, fn in (
        ("k4", flash.auto_train_attention()), ("plain", plain_attention),
        ("delta_f32", written_out_attention(False)),
        ("delta_bf16", written_out_attention(True)))}
    out = {f"{a} vs {b}": grad_agreement(g[a], g[b])[0] for a, b in (
        ("k4", "plain"), ("delta_f32", "plain"), ("delta_bf16", "plain"),
        ("k4", "delta_bf16"))}
    del g
    keep = actor.cfg
    actor.cfg = dataclasses.replace(keep, clip_ratio=1e9, clip_ratio_low=None,
                                    clip_ratio_high=None, clip_ratio_c=1e9)
    try:
        out["k4 vs plain, clips off"] = grad_agreement(
            micro_loss_grads(actor, micro, flash.auto_train_attention()),
            micro_loss_grads(actor, micro, plain_attention))[0]
    finally:
        actor.cfg = keep
    mask = micro["response_mask"] > 0
    bk, rk = clip_branch(actor, micro, flash.auto_train_attention())
    bp, _ = clip_branch(actor, micro, plain_attention)
    lo = keep.clip_ratio_low if keep.clip_ratio_low is not None else keep.clip_ratio
    hi = keep.clip_ratio_high if keep.clip_ratio_high is not None else keep.clip_ratio
    edge = torch.minimum((rk - (1 - lo)).abs(), (rk - (1 + hi)).abs()) < 1e-3
    out["tokens"] = int(mask.sum())
    out["clip branch differs"] = int(((bk != bp) & mask).sum())
    out["clipped (K4)"] = int(((bk > 0) & mask).sum())
    out["within 1e-3 of a clip edge"] = int((edge & mask).sum())
    return out


def grad_gate_sweep(dev, seeds: list[int]) -> None:
    """``--grad-seeds``: the train phase's micro gradient gate at other
    values of ``trainer.seed`` (the random weights and the sampling), each
    after the same 2-step fit on the same configuration: its readings on
    the step-1 weights (where the gate reads), and on the bf16 weights
    after the fit (where it read before), each with ``grad_gate_probes``.
    Logged, not gated: this measures the gate's spread against its limits
    (GRAD_COS_MIN_BF16, GRAD_COS_MIN), which stay as they are."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    keys = ("input_ids", "positions", "attention_mask", "responses",
            "response_mask", "advantages", "old_log_probs", "ref_log_probs")
    got: dict = {"bf16": [], "f32": [], "final": []}
    for seed in seeds:
        cfg = load_config(None, TRAIN_OVERRIDES + [f"trainer.seed={seed}"])
        cleanup: list = []
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        try:
            feed: dict = {}
            process = trainer._process_ibatch

            def keep_first(ibatch, metrics):
                out = process(ibatch, metrics)
                if not feed:
                    feed.update({k_: np.array(out[k_]) for k_ in keys})
                    feed["weights"] = _tree_map(host_copy,
                                                trainer.actor.params)
                return out

            trainer._process_ibatch = keep_first
            trainer.fit()
            actor = trainer.actor
            weights = step1_weights(feed.pop("weights"), dev)
            micro = gate_micro(feed, dev)
            with params_swapped(actor, weights):
                readings = both_precisions(actor, micro)
                probes1 = grad_gate_probes(actor, micro)
            del weights
            final = both_precisions(actor, micro)["bf16"]
            probes = grad_gate_probes(actor, micro)
        finally:
            for fn in reversed(cleanup):
                fn()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        for prec, (cos, ratio, bad_cos, bad_ratio) in readings.items():
            got[prec].append(cos)
            log(f"grad seeds: trainer.seed {seed}, step-1 {prec} weights (the "
                f"gate): cosine {cos:.6f}, norm ratio {ratio:.5f}; tile-local "
                f"fault cosine {bad_cos:.4f}, norm ratio {bad_ratio:.4f}")
        got["final"].append(final[0])
        for label, pr in (("step-1", probes1), ("final", probes)):
            log(f"grad seeds: trainer.seed {seed}, {label} bf16 weights, "
                "probes: " + ", ".join(
                    f"{k_} {v:.6f}" if isinstance(v, float) else f"{k_} {v}"
                    for k_, v in pr.items()))
    for prec, lim in (("bf16", GRAD_COS_MIN_BF16), ("f32", GRAD_COS_MIN),
                      ("final", GRAD_COS_MIN_BF16)):
        c = got[prec]
        log(f"grad seeds: {prec} cosine over seeds {seeds}: min {min(c):.6f}, "
            f"median {statistics.median(c):.6f}, max {max(c):.6f}; "
            f"{sum(x < lim for x in c)} of {len(c)} below the limit {lim}")


# -- phase 5: PPO with a critic on packed rows, pipelined, through the trainer --


PACK_LEN = 1024
PPO_RESPONSE = 256
VAL_RESPONSE = 64
PACK_KEYS = ("input_ids", "positions", "attention_mask", "segment_ids",
             "loss_mask")
K4_NAMES = ("flash_attention_fwd", "flash_attention_bwd")
PPO_KERNELS = ("paged_kv_write_fused", "paged_attention") + K4_NAMES
# the critic's packed values against its padded ones, by relative Frobenius
# error over the response tokens: both passes run the same bf16 weights
# through K4 in another layout (other matrix shapes, so other bf16 rounding
# orders) through 28 layers, which moves the logprobs by up to 0.1 nats in
# the same comparison; an H100 reads 0.027, and the packs with collapsed
# segments 1.08
PACKED_VALUE_TOL = 5e-2


def ppo_overrides(val_path: str) -> list[str]:
    """The phase's configuration: the train phase's model, engine and batch
    with the critic (GAE), packed rows of 1024 columns (4 per micro), the
    pipeline one step ahead with importance correction, and validation
    before training and after every step."""
    return [
        "device=cuda", f"model.preset={MODEL}", "model.dtype=bfloat16",
        "tokenizer.kind=byte", "data.train_path=arithmetic",
        f"data.val_path={val_path}",
        "rollout.max_slots=64", "rollout.page_size=64", "rollout.num_pages=512",
        "rollout.max_seq_len=512", "rollout.prompt_buckets=64",
        "trainer.train_batch_size=2", "trainer.rollout_n=8",
        "trainer.ppo_mini_batch_size=16", "trainer.micro_batch_size=4",
        "trainer.min_stream_batch_size=16", "trainer.max_prompt_length=64",
        f"trainer.max_response_length={PPO_RESPONSE}",
        "trainer.adv_estimator=gae", "trainer.use_remove_padding=true",
        f"trainer.pack_len={PACK_LEN}",
        f"trainer.micro_token_budget={4 * PACK_LEN}",
        "trainer.pipeline_depth=1", "trainer.staleness_limit=1",
        "trainer.rollout_is_correction=true",
        "trainer.val_before_train=true", "trainer.test_freq=1",
        "trainer.val_temperature=0.0",
        f"trainer.val_max_response_length={VAL_RESPONSE}",
        "trainer.total_steps=2", "trainer.temperature=1.0", "trainer.seed=0",
        "actor.remat=true", "actor.lr=1e-4", "critic.remat=true",
        "critic.lr=1e-4", "reward.num_workers=1",
    ]


def _host32(x: torch.Tensor) -> np.ndarray:
    return x.float().cpu().numpy()


def packed_gates(actor, critic, ib) -> dict:
    """Step 1, after the packed old-logprob and value passes and before any
    update: those against a padded pass over the same trajectories (K4 on
    one trajectory a row), the same packs with each row's segments
    collapsed into one (the planted fault), and the packing itself."""
    from polyrl_tpu_torch.data import packing

    packs = ib.meta_info["packs"]
    mask = np.asarray(ib["response_mask"]) > 0
    feed = {k_: ib[k_] for k_ in ("input_ids", "positions", "attention_mask",
                                  "responses", "response_mask")}
    padded_lp = _host32(actor.compute_log_prob(feed, compute_entropy=False)[0])
    padded_v = _host32(critic.compute_values(feed))
    bad_lp, bad_v = np.zeros_like(padded_lp), np.zeros_like(padded_v)
    for pack, spec in packs:
        pf = {k_: np.array(pack[k_]) for k_ in PACK_KEYS}
        pf["segment_ids"] = (pf["segment_ids"] > 0).astype(np.int32)
        spec.gather_into(_host32(actor.compute_log_prob_packed(
            pf, compute_entropy=False)[0]), bad_lp)
        spec.gather_into(_host32(critic.compute_values_packed(pf)), bad_v)

    def rel(v):
        return float(np.linalg.norm((v - padded_v)[mask])
                     / np.linalg.norm(padded_v[mask]))

    gap = np.abs(np.asarray(ib["old_log_probs"]) - padded_lp)[mask]
    bad_gap = np.abs(bad_lp - padded_lp)[mask]
    segs = [int((spec.row == r).sum()) for _, spec in packs
            for r in range(spec.n_rows)]
    n_real = int(sum(np.asarray(p["attention_mask"]).sum() for p, _ in packs))
    return dict(
        gap_max=float(gap.max()), gap_mean=float(gap.mean()),
        bad_max=float(bad_gap.max()), bad_mean=float(bad_gap.mean()),
        v_rel=rel(np.asarray(ib["values"])), bad_v_rel=rel(bad_v),
        v_max=float(np.abs(np.asarray(ib["values"]) - padded_v)[mask].max()),
        v_scale=float(np.abs(padded_v[mask]).max()), tokens=int(mask.sum()),
        segs=segs, n_packs=len(packs),
        efficiency=packing.packing_efficiency([sp for _, sp in packs], n_real,
                                              packs[0][1].n_rows, PACK_LEN),
        seg_ids=np.array(packs[0][0]["segment_ids"]))


def step_line(rec: dict) -> str:
    return (f"wall {rec['perf/step_time_s']:.2f} s; " + ", ".join(
        f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
            "gen", "reward", "old_log_prob", "values", "adv", "update_actor",
            "update_critic", "update_weight", "testing", "save_checkpoint")))


def ppo_main_run(dev, cfg) -> dict:
    from polyrl_tpu_torch.ops import core_algos
    from polyrl_tpu_torch.train import build_trainer

    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor, critic, engine = trainer.actor, trainer.critic, trainer.rollout
        log(f"ppo: {MODEL} trainer with critic up in {time.monotonic() - t0:.1f} s, "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        gate_launches: dict = {}
        seen: list = []
        step1: dict = {}
        tis: list = []
        process = trainer._process_ibatch
        mixed_tis = core_algos.mixed_version_importance_weights

        def gated_process(ibatch, metrics):
            out = process(ibatch, metrics)
            seen.append(dict(versions=np.array(out["rollout_weight_versions"]),
                             mask=np.asarray(out["response_mask"]) > 0,
                             current=int(engine.weight_version)))
            if len(seen) == 1:  # the producer may be generating meanwhile:
                # set apart only K4, which it never launches
                with launches_apart(gate_launches, K4_NAMES):
                    step1.update(packed_gates(actor, critic, out))
            return out

        def recording_tis(*args, **kwargs):
            w, ratio, stats = mixed_tis(*args, **kwargs)
            tis.append((np.array(w), np.asarray(args[2]) > 0))
            return w, ratio, stats

        trainer._process_ibatch = gated_process
        core_algos.mixed_version_importance_weights = recording_tis
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        try:
            history = trainer.fit()
        finally:
            trainer._process_ibatch = process
            core_algos.mixed_version_importance_weights = mixed_tis
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9

        # the path and the run
        for name in PPO_KERNELS:
            check(launches[name] > 0, f"{name} was not launched in the ppo phase")
        check(len(history) == 3, f"{len(history)} records, not a validation "
              "record and 2 steps")
        check("val/test_score/mean" in history[0]
              and np.isfinite(history[0]["val/test_score/mean"]),
              "no finite validation score before training")
        for i, rec in enumerate(history[1:], 1):
            for key in ("actor/pg_loss", "critic/vf_loss", "actor/grad_norm",
                        "critic/grad_norm", "val/test_score/mean"):
                check(key in rec and np.isfinite(rec[key]),
                      f"ppo step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0 and rec["critic/grad_norm"] > 0,
                  f"ppo step {i}: a zero gradient")
            check(rec["actor/nonfinite_skips"] == 0,
                  f"ppo step {i}: a non-finite update was skipped")
        check(engine.weight_version == 3,
              f"weight_version {engine.weight_version} after 2 steps, not 3")
        trainer._wait_pushed()
        for (name, a), (_, e) in zip(_leaves(actor.params), _leaves(engine.params)):
            check(torch.equal(a.detach(), e),
                  f"the engine's {name} differs from the actor's after the fit")

        # packing, and packed against padded
        segs = step1["segs"]
        log(f"ppo: step 1 packed {len(seen[0]['mask'])} trajectories into "
            f"{step1['n_packs']} packs of 4 x {PACK_LEN}: segments per row "
            f"{segs}, packing_efficiency {step1['efficiency']:.4f}")
        check(sum(n >= 2 for n in segs) * 2 > len(segs),
              f"most packed rows should carry 2 or more segments: {segs}")
        log(f"ppo: step-1 packed old logprobs vs a padded pass over the same "
            f"{step1['tokens']} response tokens: max {step1['gap_max']:.4f}, "
            f"mean {step1['gap_mean']:.5f} nats (tolerance {LOGP_AGREE_TOL}); "
            f"each row's segments collapsed into one: max {step1['bad_max']:.4f}, "
            f"mean {step1['bad_mean']:.4f} nats, margin "
            f"{step1['bad_max'] - LOGP_AGREE_TOL:.4f} over the tolerance (must fail)")
        check(step1["gap_max"] <= LOGP_AGREE_TOL,
              f"packed old logprobs disagree with the padded pass "
              f"({step1['gap_max']:.4f} nats > {LOGP_AGREE_TOL})")
        check(step1["bad_max"] > LOGP_AGREE_TOL,
              "the packed logprob gate passes collapsed segment ids")
        log(f"ppo: step-1 packed values vs padded: relative error "
            f"{step1['v_rel']:.5f} (tolerance {PACKED_VALUE_TOL}), max "
            f"{step1['v_max']:.5f} of values up to {step1['v_scale']:.4f}; with "
            f"collapsed segments {step1['bad_v_rel']:.5f}")
        check(step1["v_rel"] <= PACKED_VALUE_TOL,
              f"packed values disagree with the padded pass ({step1['v_rel']:.5f})")

        # staleness and the importance weights
        lim = cfg.trainer.staleness_limit
        s2 = seen[1]
        v2 = s2["versions"][s2["mask"]]
        check((v2 >= 0).all(), "step 2 has tokens of unknown weight version")
        lags = s2["current"] - v2
        hist_lag = {int(x): int((lags == x).sum()) for x in np.unique(lags)}
        log(f"ppo: step 2 trained against weight version {s2['current']}; its "
            f"tokens' version lag (tokens per lag) {json.dumps(hist_lag)}; "
            f"staleness_limit {lim}")
        check(int(lags.max()) <= lim, f"step 2 tokens {int(lags.max())} versions "
              f"stale, limit {lim}")
        # each token carries the version of the dispatch that sampled it, so
        # a trajectory's versions never decrease
        for i, sv in enumerate(seen, 1):
            for row, m in zip(sv["versions"], sv["mask"]):
                check((np.diff(row[m]) >= 0).all(),
                      f"step {i}: a trajectory's weight versions decrease")
        n_mixed = sum(len(np.unique(row[m])) > 1 for row, m in
                      zip(s2["versions"], s2["mask"]))
        log(f"ppo: versions never decrease along a trajectory; {n_mixed} of "
            f"step 2's {len(s2['mask'])} span two versions; " + engine_line(engine))
        cap = cfg.trainer.rollout_is_cap
        w_all = np.concatenate([w[m] for w, m in tis])
        log(f"ppo: TIS weights over {len(w_all)} tokens in {len(tis)} ibatches: "
            f"min {w_all.min():.4f}, mean {w_all.mean():.4f}, max "
            f"{w_all.max():.4f} (cap {cap})")
        check(len(tis) == 2 and np.isfinite(w_all).all()
              and w_all.max() <= cap + 1e-6,
              "importance weights not finite or above the cap")

        # validation: repeatable on the same weights
        m1, m2 = trainer._validate(), trainer._validate()
        log(f"ppo: validation twice on the final weights: {json.dumps(m1)}; "
            f"{json.dumps(m2)}")
        check(m1 == m2, "two validations on the same weights disagree")

        for i, rec in enumerate(history[1:], 1):
            log(f"ppo: step {i}: {step_line(rec)}; tokens/s "
                f"{rec['perf/throughput_tokens_per_s']:.1f}, mfu "
                f"{rec['perf/mfu']:.5f}; pg_loss {rec['actor/pg_loss']:.5f}, "
                f"vf_loss {rec['critic/vf_loss']:.5f}, grad_norm actor "
                f"{rec['actor/grad_norm']:.4f} critic {rec['critic/grad_norm']:.4f}; "
                + ", ".join(f"{k_} {v:.4f}" for k_, v in sorted(rec.items())
                            if k_.startswith(("perf/pipeline_", "perf/staleness_",
                                              "perf/weight_staleness")))
                + f"; val/test_score/mean {rec['val/test_score/mean']:.4f}")
        log(f"ppo: validation before training took "
            f"{history[0]['timing_s/testing']:.2f} s; fit wall {fit_wall:.1f} s; "
            f"peak memory {peak_gb:.2f} GB; main-path launches "
            f"{json.dumps(launches)}; the gates' own K4 launches "
            f"{json.dumps(gate_launches)}")
        return dict(launches=launches, history=history, peak_gb=peak_gb,
                    fit_wall=fit_wall, seg_ids=step1["seg_ids"])
    finally:
        for fn in reversed(cleanup):
            fn()


def ppo_ab() -> None:
    """The phase's configuration without validation or gates, unpipelined
    (``pipeline_depth=0``) against pipelined, in turns (serial, pipelined,
    pipelined, serial), 3 steps each: their step walls and fit walls."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    walls: dict = {0: [], 1: []}
    for depth in (0, 1, 1, 0):
        cfg = load_config(None, ppo_overrides("") + [
            "trainer.val_before_train=false", "trainer.test_freq=0",
            f"trainer.pipeline_depth={depth}", "trainer.total_steps=3"])
        cleanup: list = []
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        try:
            t0 = time.monotonic()
            history = trainer.fit()
            torch.cuda.synchronize()
            fit_wall = time.monotonic() - t0
        finally:
            for fn in reversed(cleanup):
                fn()
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
        label = "pipelined" if depth else "serial"
        walls[depth] += [rec["perf/step_time_s"] for rec in history[1:]]
        for i, rec in enumerate(history, 1):
            log(f"ppo a/b {label}: step {i}: {step_line(rec)}; overlap "
                f"{rec.get('perf/pipeline_overlap_s', 0.0):.2f}")
        log(f"ppo a/b {label}: fit wall {fit_wall:.1f} s for 3 steps")
    med = {d: statistics.median(w) for d, w in walls.items()}
    log(f"ppo a/b: median wall of steps 2-3, serial {med[0]:.2f} s, pipelined "
        f"{med[1]:.2f} s ({med[1] / med[0]:.3f} x)")


def ppo_resume(tmp: str) -> None:
    """Save at step 1 on a depth-2 copy of the same widths; a fresh trainer
    resumes it (step, dataloader position, and every parameter and
    optimizer tensor of actor and critic bitwise the saved ones) and
    trains step 2 to finite values."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    ck = os.path.join(tmp, "ckpt")
    base = ppo_overrides("") + ['model.overrides={"num_layers": 2}',
                                f"trainer.ckpt_dir={ck}",
                                "trainer.val_before_train=false",
                                "trainer.test_freq=0"]
    cleanup: list = []
    try:
        ta = build_trainer(load_config(None, base + ["trainer.total_steps=1"]),
                           cleanup, compute_score=byte_length_score)
        ha = ta.fit()
        # the host snapshot: pageable copies (the save before pinned staging)
        # against the save's own pinned staging buffers (allocated by the
        # save above, reused here), in turns on the same state
        state = ta._ckpt_state()
        snaps: dict = {"pageable": [], "pinned": []}
        for kind in ("pageable", "pinned", "pinned", "pageable"):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            if kind == "pageable":
                copy = {n: {k_: v.detach().to("cpu", copy=True)
                            for k_, v in flat.items()} for n, flat in state.items()}
            else:
                copy = {n: ta._ckpt._host_copy(n, flat) for n, flat in state.items()}
            snaps[kind].append(time.monotonic() - t0)
            del copy
        del state
        step_dir = os.path.join(ck, "global_step_1")
        nbytes = sum(os.path.getsize(os.path.join(step_dir, f))
                     for f in os.listdir(step_dir))
        tb = build_trainer(load_config(None, base + ["trainer.total_steps=2"]),
                           cleanup, compute_score=byte_length_score)
        t0 = time.monotonic()
        check(tb._load_checkpoint(), "no checkpoint to resume")
        restore_s = time.monotonic() - t0
        check(tb.global_step == 1, f"resumed at step {tb.global_step}, not 1")
        check(tb.dataloader.consumed == ta.dataloader.consumed,
              "the resumed dataloader's position differs")
        n = 0
        for name, a, b in (("actor", ta.actor, tb.actor),
                           ("critic", ta.critic, tb.critic)):
            sa, sb = a.state_dict(), b.state_dict()
            check(sa.keys() == sb.keys(), f"{name}: other tensors after resume")
            for k_ in sa:
                check(torch.equal(sa[k_], sb[k_]),
                      f"{name} {k_} differs from the saved one after resume")
            n += len(sa)
        # the resumed trainer trains on without saving again (disk)
        tb._ckpt = None
        hb = tb.fit()
        check(len(hb) == 1 and tb.global_step == 2, "the resumed fit did not "
              "run step 2 alone")
        for key in ("actor/pg_loss", "critic/vf_loss", "actor/grad_norm",
                    "critic/grad_norm"):
            check(np.isfinite(hb[0][key]), f"resumed step 2: {key} not finite")
        log(f"ppo resume (2 layers, same widths): checkpoint of step 1 "
            f"{nbytes / 1e9:.3f} GB in {len(os.listdir(step_dir))} files; save: "
            f"host snapshot {ha[0]['timing_s/save_checkpoint']:.2f} s (pinned "
            f"staging, allocated by this first save: {ta._ckpt.last_snapshot_s:.2f}"
            f" s of it), write "
            f"{ta._ckpt.last_write_s:.2f} s; restore {restore_s:.2f} s; "
            f"{n} tensors of actor and critic bitwise equal; dataloader at "
            f"{tb.dataloader.consumed}; resumed step 2: pg_loss "
            f"{hb[0]['actor/pg_loss']:.5f}, vf_loss {hb[0]['critic/vf_loss']:.5f}, "
            f"wall {hb[0]['perf/step_time_s']:.2f} s")
        log(f"ppo snapshot a/b (the same state, in turns): pageable "
            f"{', '.join(f'{t:.2f}' for t in snaps['pageable'])} s; pinned "
            f"staging, buffers reused {', '.join(f'{t:.2f}' for t in snaps['pinned'])}"
            f" s")
    finally:
        for fn in reversed(cleanup):
            fn()


def ppo_phase(dev, ab: bool) -> dict:
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.data.dataset import make_arithmetic_dataset

    with tempfile.TemporaryDirectory(prefix="ppo-smoke-") as tmp:
        val_path = os.path.join(tmp, "val.jsonl")
        with open(val_path, "w") as f:
            for rec in make_arithmetic_dataset(8, seed=1).records:
                f.write(json.dumps(rec) + "\n")
        out = ppo_main_run(dev, load_config(None, ppo_overrides(val_path)))
        gc.collect()
        torch.cuda.empty_cache()
        if ab:
            ppo_ab()
        ppo_resume(tmp)
        gc.collect()
        torch.cuda.empty_cache()
    return out

# -- phase 6: a pretrained checkpoint in Hugging Face's layout (hf) ---------------

HF_TOKENS = 32  # greedy tokens compared between the checkpoint and the preset


def greedy_run(port: int, prompt: list[int], n: int, rid: str) -> dict:
    """One greedy request alone, from an empty prefix cache."""
    post(port, "/flush_cache", {})
    return run_requests(port, [{"rid": rid, "input_ids": prompt,
                                "sampling_params": {"temperature": 0.0,
                                                    "max_new_tokens": n}}])[0]


def hf_phase(dev) -> dict:
    """``qwen3-1.7b`` at full width and depth from ``init_params`` seed 0,
    written as a Hugging Face checkpoint (two bf16 safetensors shards,
    ``model.safetensors.index.json`` and a ``config.json`` in Qwen3's
    schema; ``hf_loader.save_hf_checkpoint``, the loader's map inverted)
    into a temp dir; ``build_from_hf`` on the card must give the config
    and every leaf of the seeded tree bitwise; the int8 load's bytes; then
    ``create_server(model=<dir>)`` must serve one greedy request with the
    tokens of ``create_server("qwen3-1.7b", seed=0)``."""
    from polyrl_tpu_torch.models import hf_loader, quant
    from polyrl_tpu_torch.rollout.serve import create_server

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    geom = dict(device=str(dev), host="127.0.0.1", port=0, max_slots=8,
                page_size=PS, max_seq_len=1024, num_pages=128, seed=0)
    prompt = serving_mix(cfg.vocab_size)[1][0]
    with tempfile.TemporaryDirectory(prefix="hf-smoke-") as tmp:
        params = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
        t0 = time.monotonic()
        n_bytes = hf_loader.save_hf_checkpoint(tmp, params, cfg,
                                               model_type="qwen3", n_shards=2)
        write_s = time.monotonic() - t0
        files = sorted(os.listdir(tmp))
        check(files == ["config.json", "model-00001-of-00002.safetensors",
                        "model-00002-of-00002.safetensors",
                        "model.safetensors.index.json"], f"checkpoint files {files}")
        torch.cuda.synchronize()
        t0 = time.monotonic()
        cfg2, loaded = hf_loader.build_from_hf(tmp, dtype=torch.bfloat16, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        check(cfg2 == cfg, f"config.json round trip: {cfg2} != {cfg}")
        want = dict(quant.named_leaves(params))
        got = dict(quant.named_leaves(loaded))
        check(got.keys() == want.keys(), "the loaded tree has other leaves")
        for k_ in want:
            check(torch.equal(got[k_], want[k_]),
                  f"the loaded {k_} differs from the seeded tree")
        del loaded, got
        t0 = time.monotonic()
        _, q = hf_loader.build_from_hf(tmp, dtype=torch.bfloat16, quantize="int8",
                                       device=dev)
        torch.cuda.synchronize()
        q_s = time.monotonic() - t0
        q_bytes = quant.weight_bytes(q)
        on_card = dict(quant.named_leaves(quant.quantize_params(params)))
        n_q = sum(t.numel() for k_, t in quant.named_leaves(q) if k_.endswith(".q"))
        n_diff = sum(int((t != on_card[k_]).sum())
                     for k_, t in quant.named_leaves(q) if k_.endswith(".q"))
        check(n_diff == 0, f"the host's int8 load differs from quantizing on "
              f"the card in {n_diff} of {n_q} entries")
        del q, on_card, want, params
        gc.collect()
        torch.cuda.empty_cache()
        log(f"hf: wrote {MODEL} ({cfg.num_layers} layers) as 2 bf16 shards, "
            f"{n_bytes / 1e9:.3f} GB in {write_s:.2f} s; build_from_hf to the "
            f"card {load_s:.2f} s ({n_bytes / 1e9 / load_s:.2f} GB/s, from the "
            f"page cache), config and every leaf bitwise the seeded tree; int8 "
            f"load (quantized on the host) {q_s:.2f} s, {q_bytes / 1e9:.3f} GB "
            f"on the card; {n_diff} of {n_q} int8 entries differ from "
            f"quantizing the seeded tree on the card")
        server = create_server(tmp, **geom)
        try:
            hf_out = greedy_run(server.port, prompt, HF_TOKENS, "hf")
        finally:
            server.stop()
    server = create_server(MODEL, **geom)
    try:
        preset_out = greedy_run(server.port, prompt, HF_TOKENS, "preset")
    finally:
        server.stop()
    check(hf_out["tokens"] == preset_out["tokens"],
          "the checkpoint's server gave other greedy tokens than the preset's")
    log(f"hf: create_server(model=<dir>) served {HF_TOKENS} greedy tokens equal "
        f"to the preset engine's on the seeded tree")
    return dict(bytes=n_bytes, load_s=load_s, int8_bytes=q_bytes, int8_s=q_s)


# -- phase 7: int8 weight-only serving (quant) ---------------------------------------


def spec_bytes(cfg, nbytes: int = 2) -> float:
    """Bytes of the model's parameters at ``nbytes`` per entry."""
    def walk(specs):
        return sum(walk(v) if isinstance(v, dict) else int(np.prod(v[0]))
                   for v in specs.values())
    return walk(decoder.param_specs(cfg)) * nbytes


def dequantized_f32(tree):
    """An f32 copy of a (possibly int8) tree: ``q * scale`` per QuantWeight."""
    from polyrl_tpu_torch.models import quant

    if isinstance(tree, dict):
        return {k_: dequantized_f32(v) for k_, v in tree.items()}
    if isinstance(tree, quant.QuantWeight):
        return quant.dequantize(tree)
    return tree.float()


def quant_decode_ab(dev, cfg, trees: dict, tag: str = "quant") -> dict:
    """The decode step (the fused route) captured as a CUDA graph once per
    weight tree (two: bf16 and int8, or bf16 and LoRA-wrapped) at the
    serving tables, on the same pools of random K/V: each replay bitwise
    its eager step on the live slots, the capture's graph-pool growth
    logged; then AB_STEPS replays per tree in turns (a, b, b, a) with wall
    ms per step, and PROF_STEPS more per tree under torch.profiler for
    kernels and device ms."""
    a_, b_ = trees
    table, lens, _ = serving_tables(dev)
    active = lens > 0
    pools = decoder.make_paged_pools(cfg, int(table.max()) + 1, PS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for p_ in pools[0] + pools[1]:
        p_.normal_(generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (S,), generator=gen, device=dev)
    graphs, outs = {}, {}
    for name, params in trees.items():
        def step(params=params):
            return decoder.forward_paged_decode(params, cfg, tokens, lens, pools,
                                                table, lens, active=active)[0]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = step().clone()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        base = torch.cuda.memory_allocated(dev)
        graph = torch.cuda.CUDAGraph()
        # captured as the engine captures (thread_local): a server of this
        # process (lora_delta's) runs CUDA work on its own threads meanwhile;
        # and no garbage collection inside, where a freed graph ends the
        # capture
        gc.disable()
        try:
            with cuda_build.recording_launches() as rec:
                with torch.cuda.graph(graph, stream=side,
                                      capture_error_mode="thread_local"):
                    out = step()
        finally:
            gc.enable()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out[active], eager[active]),
              f"the {name} decode step's replay differs from its eager step")
        graphs[name] = (graph, rec,
                        (torch.cuda.max_memory_allocated(dev) - base) / 1e9)
        outs[name] = torch.log_softmax(out[active].float(), dim=-1)
    gap = (outs[b_] - outs[a_]).abs().max().item()
    agree = (outs[b_].argmax(-1) == outs[a_].argmax(-1)).float().mean().item()
    del outs

    def replay(name):
        graphs[name][0].replay()
        cuda_build.credit_launches(graphs[name][1])

    walls = {n: [] for n in trees}
    launches = {n: dict.fromkeys(cuda_build.LAUNCHES, 0) for n in trees}
    for name in (a_, b_, b_, a_):
        cuda_build.reset_launch_counts()
        for _ in range(AB_STEPS // 2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            replay(name)
            torch.cuda.synchronize()
            walls[name].append((time.monotonic() - t0) * 1e3)
        for k_, n in cuda_build.LAUNCHES.items():
            launches[name][k_] += n
    out = {}
    for name in trees:
        check(launches[name]["paged_kv_write_fused"] == cfg.num_layers * AB_STEPS,
              f"the {name} replays' launches: {launches[name]}")
        pr = device_profile(lambda name=name: replay(name), PROF_STEPS)
        w = sorted(walls[name])
        out[name] = dict(wall_ms=statistics.median(w), device_ms=pr["device_ms"],
                         kernels=pr["kernels"], pool_gb=graphs[name][2])
        log(f"{tag} decode a/b {name} (graph replay): wall ms per step median "
            f"{out[name]['wall_ms']:.2f} (min {w[0]:.2f}, max {w[-1]:.2f}; "
            f"{len(w)} steps), device ms per step {pr['device_ms']:.3f}, kernels "
            f"per step {pr['kernels']:.1f} (+ {pr['copies']:.1f} copies/sets); "
            f"the capture grew the allocation by {graphs[name][2]:.3f} GB "
            f"(graph pool peak)")
    log(f"{tag} decode a/b: {b_} against {a_} log-softmax of the live slots: "
        f"max |diff| {gap:.4f} nats, argmax agreement {agree:.3f} (not gated "
        f"here)")
    del graphs
    return out


def quant_host_parity(dev) -> None:
    """``quant.quantize_tensor`` on the card against the same call on the
    host, on every projection of the seeded ``qwen3-1.7b`` tree: the int8
    entries and the f32 scales must be bitwise equal (the host path is
    pinned to the reference's numpy by the CPU tests). Also logs what the
    former divisor, the Python scalar 127.0, gives on the card (CUDA
    multiplies by its rounded reciprocal): the scales and entries that
    differ from the host's, the cause of the two paths' disagreement."""
    from polyrl_tpu_torch.models import quant

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    params = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    t0 = time.monotonic()
    n_q = n_dq = n_ds = n_old_s = n_old_q = 0
    projections = [(f"layers.{k_}", -2) for k_ in quant.QUANTIZED_LAYER_KEYS
                   if k_ in params["layers"]]
    if "lm_head" in params:
        projections.append(("lm_head", 0))
    leaves = dict(quant.named_leaves(params))
    for name, axis in projections:
        w = leaves[name]
        card = quant.quantize_tensor(w, contract_axis=axis)
        host = quant.quantize_tensor(w.cpu(), contract_axis=axis)
        n_q += card.q.numel()
        n_dq += int((card.q.cpu() != host.q).sum())
        n_ds += int((card.scale.cpu() != host.scale).sum())
        wf = w.float()
        old = wf.abs().amax(dim=axis) / 127.0 + 1e-12
        old_q = torch.clamp(torch.round(wf / old.unsqueeze(axis)), -127, 127)
        n_old_s += int((old.cpu() != host.scale).sum())
        n_old_q += int((old_q.to(torch.int8).cpu() != host.q).sum())
        del wf, old, old_q
    del params, leaves
    gc.collect()
    torch.cuda.empty_cache()
    log(f"quant: quantize_tensor card against host on {len(projections)} "
        f"projections: {n_dq} of {n_q} int8 entries and {n_ds} scales differ "
        f"({time.monotonic() - t0:.1f} s); with the divisor the Python scalar "
        f"127.0 on the card, {n_old_s} scales and {n_old_q} entries would")
    check(n_dq == 0 and n_ds == 0,
          "quantize_tensor on the card differs from the host's")


def quant_phase(dev) -> dict:
    """``create_server("qwen3-1.7b", weight_quant="int8")`` (the preset made
    int8 leaf by leaf on the card) at the serving geometry, over HTTP: the
    serving mix and then one greedy request twice alone, with launch
    counts zeroed just before and read just after (the fused prologue, K2
    and K3 must launch; K1 alone must not); the greedy request's two
    runs the same tokens; its logprobs within
    DENSE_LOGP_TOL of the dense f32 ``forward`` on the dequantized
    weights; a bf16 ``update_weights`` refused; the same bf16 tree pushed
    through the server's ``weight_preprocess`` (re-quantized) serving the
    first greedy tokens again; then ``quant_decode_ab``."""
    from polyrl_tpu_torch.models import quant
    from polyrl_tpu_torch.rollout.serve import create_server

    quant_host_parity(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.monotonic()
    server = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                           max_slots=64, page_size=64, max_seq_len=4096,
                           num_pages=2048, steps_per_dispatch=8, seed=0,
                           weight_quant="int8")
    try:
        eng, port = server.engine, server.port
        cfg = eng.cfg
        int8_gb = quant.weight_bytes(eng.params) / 1e9
        bf16_gb = spec_bytes(cfg) / 1e9
        log(f"quant: {MODEL} int8 up in {time.monotonic() - t0:.1f} s; weights "
            f"{int8_gb:.3f} GB int8 (bf16 embedding and norms, f32 scales) "
            f"against {bf16_gb:.3f} GB bf16")
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)
        run_requests(port, [{"rid": "warmup", "input_ids": warm,
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})
        # the main path: the mix, then one greedy request twice alone;
        # counts zeroed just before and read just after. Whether the mix
        # alone ends on ungrouped dispatches (K2) depends on when its
        # greedy streams were admitted; the lone requests always do.
        info0 = post(port, "/get_server_info", None)
        cuda_build.reset_launch_counts()
        t_start = time.monotonic()
        outs = run_requests(port, bodies)
        wall = time.monotonic() - t_start
        mix_launches = dict(cuda_build.LAUNCHES)
        info = post(port, "/get_server_info", None)
        rep = [greedy_run(port, greedy_prompts[0], 64, f"qrep{i}") for i in range(2)]
        launches = dict(cuda_build.LAUNCHES)
        log(f"quant: main path launches {json.dumps(launches)} (the mix's "
            f"{json.dumps(mix_launches)}); the mix: " + dispatch_line(info0, info))
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"{name} was not launched serving int8: "
                  f"{json.dumps(launches)}")
        check(launches["paged_kv_write"] == 0,
              "the int8 serving path took the unfused K/V write")
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0,
                  "int8 serving: non-finite or positive logprob")
        tok_s = mix_tok_s(outs)
        ttft = [o["lines"][0][0] - o["t0"] for o in outs]
        check(rep[0]["tokens"] == rep[1]["tokens"],
              "int8 serving: the same greedy request gave different tokens")
        n_p = len(greedy_prompts[0])
        params32 = dequantized_f32(eng.params)
        x = torch.tensor([greedy_prompts[0] + rep[0]["tokens"]], device=dev)
        logits, _ = decoder.forward(params32, cfg, x,
                                    torch.arange(x.shape[1], device=dev)[None],
                                    torch.ones_like(x, dtype=torch.float32),
                                    attn_fn=flash.flash_attention_train_ref)
        lsm32 = torch.log_softmax(logits[0, n_p - 1:-1].float(), dim=-1)
        del logits, params32
        gen_t = torch.tensor(rep[0]["tokens"], device=dev)
        ref = lsm32.gather(-1, gen_t[:, None])[:, 0]
        lp_err = (ref - torch.tensor(rep[0]["logprobs"], device=dev)).abs().max().item()
        gap = (lsm32.max(dim=-1).values - ref).max().item()
        del lsm32
        log(f"quant: greedy decode vs the dense f32 forward on the dequantized "
            f"weights: max |logprob diff| {lp_err:.4f} nats, max f32 gap of the "
            f"chosen token {gap:.4f} (tolerance {DENSE_LOGP_TOL})")
        check(lp_err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
              f"int8 decode disagrees with the dense forward ({lp_err:.4f}, "
              f"{gap:.4f} nats)")
        bf = decoder.init_params(torch.Generator(device=dev).manual_seed(0),
                                 decoder.get_config(MODEL, dtype=torch.bfloat16))
        try:
            eng.update_weights(bf)
            refused = ""
        except ValueError as exc:
            refused = str(exc)
        check(bool(refused), "a bf16 update_weights into the int8 engine was accepted")
        v0 = eng.weight_version
        t0 = time.monotonic()
        server.update_weights(bf)
        torch.cuda.synchronize()
        push_s = time.monotonic() - t0
        check(eng.weight_version == v0 + 1, "the re-quantized push did not land")
        after = greedy_run(port, greedy_prompts[0], 64, "qpush")
        check(after["tokens"] == rep[0]["tokens"],
              "the re-quantized push (the same seed-0 weights) serves other tokens")
        log(f"quant: a bf16 update_weights refused ({refused[:90]}...); the same "
            f"tree through weight_preprocess (re-quantized on the card, "
            f"{push_s:.2f} s) installed as version {eng.weight_version} and served "
            f"the same greedy tokens")
        ab = quant_decode_ab(dev, cfg, {"bf16": bf, "int8": eng.params})
        del bf
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"quant: decode "
            f"{tok_s:.1f} tok/s over 18 streams (the serve phase's mix, its first "
            f"run with the capture), TTFT median "
            f"{statistics.median(ttft) * 1e3:.1f} ms; {wall:.2f} s; peak "
            f"{peak_gb:.2f} GB (torch.cuda.max_memory_allocated)")
        return dict(launches=launches, tok_s=tok_s, peak_gb=peak_gb,
                    int8_gb=int8_gb, bf16_gb=bf16_gb, ab=ab)
    finally:
        server.stop()


# -- phase 8: LoRA training, optimizer offload, step profiling (lora) ----------------

LORA_RANK = 16
LORA_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


def lora_phase(dev, full_peak_gb: float) -> dict:
    """The train phase's configuration with ``actor.lora_rank=16
    lora_alpha=16``, 2 GRPO steps. Gates: finite losses and grad norms,
    the frozen leaves (every base, embed, norms) bitwise the reference
    policy's copy of the initial weights, every ``b`` moved from zero, the
    engine after each push bitwise ``merge_lora(actor.params)``, step 1's
    old logprobs within LOGP_AGREE_TOL of the engine's, K4 forward and
    backward launched (counted from zero). ``offload_checks`` follows it
    in ``main``, once this phase's trainer is gone."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.models import lora, quant
    from polyrl_tpu_torch.train import build_trainer

    cfg = load_config(None, TRAIN_OVERRIDES + [f"actor.lora_rank={LORA_RANK}",
                                               "actor.lora_alpha=16"])
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor, engine, ref = trainer.actor, trainer.rollout, trainer.ref_policy
        n_train = lora.num_trainable(actor.params)
        opt_bytes = sum(t.numel() * t.element_size()
                        for t in actor.opt_state.mu + actor.opt_state.nu)
        log(f"lora: trainer up in {time.monotonic() - t0:.1f} s; rank "
            f"{LORA_RANK}, {n_train} trainable parameters "
            f"({n_train / 1e6:.2f} M) in {len(actor._named)} tensors, optimizer "
            f"state {opt_bytes / 1e9:.4f} GB; "
            f"{torch.cuda.memory_allocated(dev) / 1e9:.2f} GB allocated")
        pushes: list[bool] = []
        push = trainer._push_weights

        def checked_push(block: bool = True) -> None:
            push(block)
            with torch.no_grad():
                merged = dict(quant.named_leaves(lora.merge_lora(actor.params)))
            pushes.append(all(torch.equal(e, merged[n].detach())
                              for n, e in quant.named_leaves(engine.params)))

        step1: dict = {}
        process = trainer._process_ibatch

        def first_ibatch_gate(ibatch, metrics):
            out = process(ibatch, metrics)
            if not step1:
                mask = np.asarray(out["response_mask"]) > 0
                gap = np.abs(np.asarray(out["old_log_probs"])
                             - np.asarray(out["rollout_log_probs"]))[mask]
                step1.update(gap_max=float(gap.max()), gap_mean=float(gap.mean()),
                             tokens=int(mask.sum()))
            return out

        trainer._push_weights = checked_push
        trainer._process_ibatch = first_ibatch_gate
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        trainer._push_weights, trainer._process_ibatch = push, process

        check(len(history) == 2, "the LoRA fit did not run 2 steps")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(np.isfinite(rec[key]), f"lora step {i}: {key} not finite")
            check(rec["actor/grad_norm"] > 0, f"lora step {i}: zero gradient")
            check(rec["actor/nonfinite_skips"] == 0, f"lora step {i}: skipped update")
        check(pushes == [True] * 3, f"the engine after each push equal to the "
              f"merge: {pushes}")
        check(engine.weight_version == 3, f"weight_version {engine.weight_version}")
        for k_, w in actor.params["layers"].items():
            want = ref.params["layers"][k_]
            if isinstance(w, quant.LoraWeight):
                check(torch.equal(w.base, want), f"the frozen base of {k_} moved")
                check(float(w.b.detach().abs().max()) > 0, f"{k_}.b stayed zero")
            else:
                check(torch.equal(w, want), f"the frozen {k_} moved")
        for k_ in ("embed", "final_norm"):
            check(torch.equal(actor.params[k_], ref.params[k_]), f"{k_} moved")
        for name in LORA_KERNELS:
            check(launches[name] > 0, f"{name} was not launched in the LoRA fit")
        check(step1["gap_max"] <= LOGP_AGREE_TOL,
              f"LoRA old logprobs disagree with the engine's ({step1['gap_max']:.4f})")
        log(f"lora: step-1 old logprobs (K4 through the wrapped projections) vs "
            f"the engine's over {step1['tokens']} tokens: max "
            f"{step1['gap_max']:.4f}, mean {step1['gap_mean']:.5f} nats "
            f"(tolerance {LOGP_AGREE_TOL}); the engine bitwise merge_lora(actor."
            f"params) after each of 3 pushes; frozen leaves bitwise; every b moved")
        for i, rec in enumerate(history, 1):
            log(f"lora: step {i}: wall {rec['perf/step_time_s']:.2f} s; "
                + ", ".join(f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
                    "gen", "old_log_prob", "ref_log_prob", "update_actor",
                    "update_weight"))
                + f"; pg_loss {rec['actor/pg_loss']:.5f}, grad_norm "
                f"{rec['actor/grad_norm']:.4f}")
        log(f"lora: fit wall {fit_wall:.1f} s; peak {peak_gb:.2f} GB against "
            f"{full_peak_gb:.2f} GB for the full fine-tune (train phase); "
            f"main-path launches {json.dumps(launches)}")
        return dict(launches=launches, peak_gb=peak_gb, n_train=n_train,
                    opt_bytes=opt_bytes, history=history)
    finally:
        for fn in reversed(cleanup):
            fn()


def offload_micro(dev, cfg, seed: int) -> dict:
    """A synthetic micro at the train phase's shapes (4 rows, 64 + 448
    tokens)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    b, tp, tr = 4, 64, 448
    ids = torch.randint(1, cfg.vocab_size, (b, tp + tr), generator=g, device=dev)
    return {"input_ids": ids,
            "positions": torch.arange(tp + tr, device=dev).expand(b, -1).int(),
            "attention_mask": torch.ones((b, tp + tr), device=dev),
            "responses": ids[:, tp:], "response_mask": torch.ones((b, tr), device=dev),
            "advantages": torch.randn((b, tr), generator=g, device=dev),
            "old_log_probs": -12.0 + 0.1 * torch.randn((b, tr), generator=g,
                                                       device=dev)}


def offload_checks(dev) -> dict:
    """Optimizer offload on the full fine-tune. (1) Two actors from the
    same seeded weights take two AdamW steps on the same micros, one with
    its moments offloaded after each step and loaded back before the next:
    every parameter bitwise the other's. (2) The train phase's fit with
    ``actor.offload_optimizer=true`` and ``trainer.profile_steps=2``: the
    device memory each offload frees and the seconds of each offload and
    load, the moments on the host after the fit, and a torch.profiler trace
    of step 2 under ``profile_dir`` naming K4's kernels."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.models import quant
    from polyrl_tpu_torch.train import build_trainer
    from polyrl_tpu_torch.trainer.actor import ActorConfig, StreamActor

    mcfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    finals = []
    for offload in (False, True):
        actor = StreamActor(mcfg, ActorConfig(lr=1e-4, remat=True,
                                              offload_optimizer=offload),
                            decoder.init_params(torch.Generator(device=dev)
                                                .manual_seed(0), mcfg))
        for i in range(2):
            actor.update_stream(offload_micro(dev, mcfg, 30 + i), is_opt_step=True)
            actor.offload_opt_state()
        check(actor._opt_offloaded == offload, "offload state after the steps")
        finals.append(dict(quant.named_leaves(actor.params)))
        del actor
        gc.collect()
        torch.cuda.empty_cache()
    for k_, v in finals[0].items():
        check(torch.equal(v, finals[1][k_]),
              f"two steps with offload differ from the same without it at {k_}")
    del finals
    gc.collect()
    torch.cuda.empty_cache()
    log("lora offload: two full-width AdamW steps with the moments offloaded "
        "after each are bitwise the same steps without offload")

    with tempfile.TemporaryDirectory(prefix="offload-smoke-") as tmp:
        prof_dir = os.path.join(tmp, "prof")
        cfg = load_config(None, TRAIN_OVERRIDES + [
            "actor.offload_optimizer=true", "trainer.profile_steps=2",
            f"trainer.profile_dir={prof_dir}"])
        torch.cuda.reset_peak_memory_stats(dev)
        cleanup: list = []
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        try:
            actor = trainer.actor
            offloads, loads = [], []
            off, load = actor.offload_opt_state, actor.load_opt_state

            def timed_offload():
                torch.cuda.synchronize()
                before, t0 = torch.cuda.memory_allocated(dev), time.monotonic()
                off()
                torch.cuda.synchronize()
                offloads.append((time.monotonic() - t0,
                                 (before - torch.cuda.memory_allocated(dev)) / 1e9))

            def timed_load():
                if not actor._opt_offloaded:
                    return
                torch.cuda.synchronize()
                t0 = time.monotonic()
                load()
                torch.cuda.synchronize()
                loads.append(time.monotonic() - t0)

            actor.offload_opt_state, actor.load_opt_state = timed_offload, timed_load
            history = trainer.fit()
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            check(len(history) == 2, "the offload fit did not run 2 steps")
            check(actor._opt_offloaded and all(
                t.device.type == "cpu" and t.is_pinned()
                for t in actor.opt_state.mu + actor.opt_state.nu),
                "the moments are not in pinned host memory after the fit")
            for i, rec in enumerate(history, 1):
                check(np.isfinite(rec["actor/grad_norm"]) and rec["actor/grad_norm"] > 0,
                      f"offload step {i}: bad grad norm")
            check(len(offloads) == 2 and len(loads) == 1,
                  f"{len(offloads)} offloads and {len(loads)} loads in 2 steps")
            traces = trainer.profile_traces
            check(len(traces) == 1 and os.path.dirname(traces[0]) == prof_dir,
                  f"profile traces {traces}")
            with open(traces[0]) as f:
                text = f.read()
            k4 = [n for n in ("flash_fwd_bf16_kernel", "flash_dq_bf16_kernel",
                              "flash_dkv_bf16_kernel") if n in text]
            check(len(k4) == 3, f"the step-2 trace names K4's kernels {k4} only")
            log(f"lora offload: fit with actor.offload_optimizer: each offload "
                f"freed {', '.join(f'{g:.3f}' for _, g in offloads)} GB of device "
                f"memory in {', '.join(f'{s:.3f}' for s, _ in offloads)} s (the "
                f"copies out, to pinned buffers); the load before step 2 took "
                f"{loads[0]:.3f} s; step walls "
                + ", ".join(f"{r['perf/step_time_s']:.2f}" for r in history)
                + f" s; peak {peak_gb:.2f} GB; profile_steps=(2,) wrote "
                f"{os.path.basename(traces[0])} ({len(text) / 1e6:.1f} MB) naming "
                + ", ".join(k4))
            return dict(offloads=offloads, loads=loads, peak_gb=peak_gb,
                        history=history)
        finally:
            for fn in reversed(cleanup):
                fn()
            gc.collect()
            torch.cuda.empty_cache()




# -- main -----------------------------------------------------------------------


# -- phase 9: the engine's serving features (features) ------------------------

# a near-tie is an f32 top-2 logit gap under NEAR_TIE: two greedy runs may
# part at the reference's first one or later, and only where its gap is
# under PART_GAP: two bf16 runs that each choose tokens within
# DENSE_LOGP_TOL of the f32 best (the dense gate) can part only there (on
# an H100, correct runs parted at gaps of 0.054-0.099: bf16 moves the
# logits by more than NEAR_TIE)
NEAR_TIE = 0.05
PART_GAP = DENSE_LOGP_TOL
CHUNK_LP_TOL = 0.05    # first-token logprob, chunked against unchunked, nats
RELEASE_MIN_GB = 14.0  # the KV pool at 2,048 pages is 15.03 GB
SPEC_TOKENS, SPEC_ROUNDS = 4, 2
FEATURE_ENGINE = dict(max_slots=S, page_size=PS, max_seq_len=4096,
                      num_pages=2048, steps_per_dispatch=8, seed=0)
# the live streams' budget while the long prompt chunks in: 48 dispatches,
# so that decode dispatches are still being issued through the admission
LIVE_NEW = 384


def dense_f32_rows(params32, cfg, prompt, tokens, dev) -> torch.Tensor:
    """The dense f32 forward's log-softmax [len(tokens), V] over ``prompt``
    + ``tokens``: row ``j`` is the distribution that predicts
    ``tokens[j]``."""
    x = torch.tensor([list(prompt) + list(tokens)], device=dev)
    pos = torch.arange(x.shape[1], device=dev)[None]
    with torch.no_grad():
        h = decoder.forward_hidden(params32, cfg, x, pos,
                                   torch.ones_like(x, dtype=torch.float32),
                                   attn_fn=flash.flash_attention_train_ref)
        logits = decoder.unembed(h[0, len(prompt) - 1:-1],
                                 decoder.head_weight(params32, cfg)).float()
    return torch.log_softmax(logits, dim=-1)


def top2_gaps(params32, cfg, prompt, tokens, dev) -> np.ndarray:
    """The dense f32 forward's top-2 logit gap at each generated position
    of ``tokens`` after ``prompt``: where it is under ``NEAR_TIE``, another
    greedy run may take the other token."""
    top2 = dense_f32_rows(params32, cfg, prompt, tokens, dev).topk(2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).cpu().numpy()


def agrees_until_tie(got, ref, gaps) -> tuple[bool, int, int, float]:
    """(``got`` equals ``ref``, or parts from it no earlier than ``ref``'s
    first near-tie (``gaps``, ``ref``'s f32 top-2 gaps, under ``NEAR_TIE``)
    and where ``ref``'s gap is under ``PART_GAP``; the first mismatch; the
    first near-tie; the gap at the first mismatch, nan when none)."""
    n = min(len(got), len(ref))
    first = next((j for j in range(n) if got[j] != ref[j]), n)
    tie = next((j for j, g in enumerate(gaps) if g < NEAR_TIE), len(gaps))
    gap = float(gaps[first]) if first < n else float("nan")
    ok = (len(got) == len(ref) if first == n
          else first >= tie and gap < PART_GAP)
    return ok, first, tie, gap


def dense_f32_gate(params32, cfg, prompt, tokens, logprobs, dev) -> tuple:
    """The serve gate's reading for one greedy stream: max |engine - dense
    f32| logprob of the chosen tokens, and the max f32 gap of the chosen
    token below the best."""
    lsm = dense_f32_rows(params32, cfg, prompt, tokens, dev)
    gen = torch.tensor(list(tokens), device=dev)
    ref = lsm.gather(-1, gen[:, None])[:, 0]
    err = (ref - torch.tensor(list(logprobs), device=dev)).abs().max().item()
    return err, (lsm.max(dim=-1).values - ref).max().item()


def f32_copy(params: dict) -> dict:
    from polyrl_tpu_torch.models.quant import tree_map

    return tree_map(lambda t: t.float(), params)


def stream_items(q, timeout: float = 600.0, into: list | None = None) -> list:
    """An engine output queue read to its end: (arrival time, line), each
    appended to ``into`` as it arrives."""
    from polyrl_tpu_torch.rollout.cb_engine import STREAM_END

    items = [] if into is None else into
    while (item := q.get(timeout=timeout)) is not STREAM_END:
        items.append((time.monotonic(), item))
    return items


def salvage_checks(eng, cfg, dev, params32) -> dict:
    """A greedy stream of budget 400 aborted after its 5th token, on the
    served engine (salvage on, the default): every token of the decode
    dispatches issued for it reaches the client before the ``abort``
    terminal, ``tokens_salvaged`` is what the fast path would have dropped
    (what the drain delivered), and prompt + partial resubmitted with the
    budget decremented hits the salvage-published pages; the stitched
    stream equals the uninterrupted run or parts from it at a near-tie,
    and its logprobs, the continuation's over the published pages
    included, hold against the dense f32 forward (``params32``). Then the
    abort-to-terminal latency with salvage on and off, in turns."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    rng = np.random.default_rng(21)
    # 120 tokens: one full page cached at admission, and any decode
    # dispatch completes the second (a page to salvage)
    prompt = rng.integers(1, cfg.vocab_size, 120).tolist()
    budget = 400
    sp = SamplingParams(temperature=0.0, max_new_tokens=budget)
    eng.flush_prefix_cache()
    ref = eng.generate([prompt], sp, timeout=600.0)[0]
    check(len(ref["token_ids"]) == budget, "the uninterrupted run fell short")
    gaps = top2_gaps(params32, cfg, prompt, ref["token_ids"], dev)

    def aborted_run(rid: str):
        ev = threading.Event()
        d0 = eng.decode_dispatches
        q = eng.submit(rid, prompt, sp, abort=ev)
        got, lps = [], []
        while len(got) < 5:
            item = q.get(timeout=600)
            got += item["token_ids"]
            lps += item["logprobs"]
        t_abort = time.monotonic()
        ev.set()
        items = stream_items(q)
        latency = items[-1][0] - t_abort
        got += [t for _, it in items for t in it["token_ids"]]
        lps += [x for _, it in items for x in it["logprobs"]]
        check(items[-1][1]["finish_reason"] == "abort",
              f"{rid}: ended {items[-1][1]['finish_reason']!r}")
        return got, lps, latency, eng.decode_dispatches - d0

    eng.flush_prefix_cache()
    seen: dict = {}
    orig = eng._abort_with_salvage

    def recording():
        seen["before"] = sum(len(i.emitted) for i in eng._slots
                             if i is not None and i.req.abort is not None
                             and i.req.abort.is_set())
        orig()

    eng._abort_with_salvage = recording
    salv0, pub0 = eng.tokens_salvaged, eng.salvage_published_pages
    try:
        got, got_lps, latency, n_disp = aborted_run("salvage")
    finally:
        eng._abort_with_salvage = orig
    k = len(got)
    salvaged = eng.tokens_salvaged - salv0
    published = eng.salvage_published_pages - pub0
    check(k == 1 + n_disp * eng.steps_per_dispatch,
          f"salvage: {k} tokens delivered, {n_disp} dispatches issued for the "
          f"stream decoded {1 + n_disp * eng.steps_per_dispatch}")
    check(salvaged == k - seen["before"] and salvaged > 0,
          f"salvage: tokens_salvaged {salvaged}, the drain delivered "
          f"{k - seen['before']}")
    ok, first, tie, gap = agrees_until_tie(got, ref["token_ids"][:k], gaps)
    check(ok, f"salvage: the partial parts from the uninterrupted run at "
              f"{first} (top-2 gap {gap:.4f}), first near-tie {tie}")
    hits0 = eng.prefix_cache.hits
    cont = eng.generate([prompt + got], dataclasses.replace(
        sp, max_new_tokens=budget - k), timeout=600.0)[0]
    hit_pages = eng.prefix_cache.hits - hits0
    check(published > 0 and hit_pages >= published,
          f"salvage: {published} pages published, the continuation hit "
          f"{hit_pages}")
    stitched = got + cont["token_ids"]
    ok, first, tie, gap = agrees_until_tie(stitched, ref["token_ids"], gaps)
    check(ok and len(stitched) == budget,
          f"salvage: the stitched stream parts from the uninterrupted run at "
          f"{first} (top-2 gap {gap:.4f}, first near-tie {tie}, "
          f"{len(stitched)} tokens)")
    err, worst_gap = dense_f32_gate(params32, cfg, prompt, stitched,
                                    got_lps + cont["logprobs"], dev)
    check(err <= DENSE_LOGP_TOL and worst_gap <= DENSE_LOGP_TOL,
          f"salvage: the stitched stream {err:.4f} / {worst_gap:.4f} nats "
          f"from the dense f32 forward")
    lat = {True: [], False: []}
    for flag in (True, False, True, False):
        eng.salvage_partials = flag
        eng.flush_prefix_cache()
        _, _, t_lat, _ = aborted_run(f"lat-{flag}-{len(lat[flag])}")
        lat[flag].append(t_lat)
    eng.salvage_partials = True
    return dict(k=k, salvaged=salvaged, published=published,
                hit_pages=hit_pages, first=first, tie=tie, gap=gap,
                dense=(err, worst_gap), n_disp=n_disp,
                latency_on=lat[True], latency_off=lat[False])


def timed_streams(qs: list) -> tuple[list, list]:
    """Read each queue on its own thread; returns (per-queue items, the
    threads), the items filling as the lines arrive."""
    outs = [[] for _ in qs]

    def read(q, out):
        stream_items(q, into=out)

    threads = [threading.Thread(target=read, args=(q, o), daemon=True)
               for q, o in zip(qs, outs)]
    for t in threads:
        t.start()
    return outs, threads


def chunk_checks(eng, cfg, dev, params32) -> dict:
    """A 3,000-token seeded prompt with ``prefill_chunk`` 512 against 0 on
    the served engine: first-token logprobs within ``CHUNK_LP_TOL``, greedy
    tokens equal or parting at a near-tie, the chunked run's logprobs
    against the dense f32 forward, the peak memory of each. Then
    the same admission while 16 greedy streams decode: at least one decode
    dispatch between consecutive chunks, and the live streams' tok/s over
    the admission, chunked against unchunked."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    rng = np.random.default_rng(22)
    long_prompt = rng.integers(1, cfg.vocab_size, 3000).tolist()
    sp = SamplingParams(temperature=0.0, max_new_tokens=32)
    res = {}
    for chunk in (512, 0):
        eng.prefill_chunk = chunk
        eng.flush_prefix_cache()
        torch.cuda.synchronize(dev)
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        c0 = eng.chunk_dispatches
        out = eng.generate([long_prompt], sp, timeout=600.0)[0]
        torch.cuda.synchronize(dev)
        res[chunk] = dict(out=out, chunks=eng.chunk_dispatches - c0,
                          peak_gb=(torch.cuda.max_memory_allocated(dev) - base) / 1e9)
    check(res[512]["chunks"] == 5 and res[0]["chunks"] == 0,
          f"chunk dispatches {res[512]['chunks']} / {res[0]['chunks']}")
    gaps = top2_gaps(params32, cfg, long_prompt, res[0]["out"]["token_ids"], dev)
    d_lp = abs(res[512]["out"]["logprobs"][0] - res[0]["out"]["logprobs"][0])
    check(d_lp <= CHUNK_LP_TOL,
          f"chunked: first-token logprob {d_lp:.4f} nats from unchunked")
    ok, first, tie, gap = agrees_until_tie(res[512]["out"]["token_ids"],
                                           res[0]["out"]["token_ids"], gaps)
    check(ok, f"chunked: greedy tokens part at {first} (top-2 gap {gap:.4f}), "
              f"first near-tie {tie}")
    err, worst_gap = dense_f32_gate(params32, cfg, long_prompt,
                                    res[512]["out"]["token_ids"],
                                    res[512]["out"]["logprobs"], dev)
    check(err <= DENSE_LOGP_TOL and worst_gap <= DENSE_LOGP_TOL,
          f"chunked: {err:.4f} / {worst_gap:.4f} nats from the dense f32 forward")
    live = {}
    for chunk in (512, 0):
        eng.prefill_chunk = chunk
        eng.flush_prefix_cache()
        qs = [eng.submit(f"live{chunk}-{i}",
                         rng.integers(1, cfg.vocab_size, 64).tolist(),
                         SamplingParams(temperature=0.0, max_new_tokens=LIVE_NEW))
              for i in range(16)]
        outs, threads = timed_streams(qs)
        t0 = time.monotonic()
        while min(len(o) for o in outs) < 8:
            check(time.monotonic() - t0 < 120, "live streams did not start")
            time.sleep(0.005)
        marks: list = []
        advance = eng._advance_chunk_job

        def recording():
            marks.append(eng.decode_dispatches)
            advance()

        eng._advance_chunk_job = recording
        try:
            t_sub = time.monotonic()
            first_line = stream_items(eng.submit(f"long{chunk}", long_prompt, sp))
        finally:
            eng._advance_chunk_job = advance
        t_first = first_line[0][0]
        for t in threads:
            t.join(timeout=600)
        n_live = sum(1 for o in outs for ts, _ in o if t_sub <= ts <= t_first)
        live[chunk] = dict(tok_s=n_live / max(t_first - t_sub, 1e-9),
                           admit_s=t_first - t_sub, marks=marks)
        if chunk:
            check(len(marks) == 6 and all(b > a for a, b in zip(marks, marks[1:])),
                  f"chunked: decode dispatches at each chunk {marks}")
    eng.prefill_chunk = 0
    return dict(d_lp=d_lp, first=first, tie=tie, gap=gap, dense=(err, worst_gap),
                peak_chunked=res[512]["peak_gb"], peak_whole=res[0]["peak_gb"],
                live=live)


def spec_probe_engine(dev, params, cfg, spec_tokens: int):
    """An engine of the served weights (not started: driven through its
    internals, with small pools) that has admitted a greedy GRPO group of
    8, a sampled one with filters (temperature 1, top-p 0.9, top-k 50), two
    greedy requests and the repetitive greedy prompt, and taken one decode
    dispatch."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    eng = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                   num_pages=160, steps_per_dispatch=8, seed=3,
                   spec_tokens=spec_tokens, spec_rounds=SPEC_ROUNDS, device=dev)
    rng = np.random.default_rng(5)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=128)
    sampled = SamplingParams(temperature=1.0, top_p=0.9, top_k=50,
                             max_new_tokens=128)
    for g, (n_p, sp) in enumerate(((200, greedy), (203, sampled))):
        prompt = rng.integers(1, cfg.vocab_size, n_p).tolist()
        for i in range(8):
            eng.submit(f"g{g}-{i}", prompt, sp, group_id=f"grp{g}", group_size=8)
    for i, n_p in enumerate((198, 205)):
        eng.submit(f"greedy{i}", rng.integers(1, cfg.vocab_size, n_p).tolist(),
                   greedy)
    eng.submit("rep", rng.integers(1, cfg.vocab_size, 16).tolist() * 8, greedy)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._drain_emit_q()
    check(int(eng._active.sum()) == 19, f"{int(eng._active.sum())} active slots")
    return eng


def replay_ms(eng, key, reps: int = 10) -> float:
    """Device ms of one replay of ``key``'s graph (CUDA events, median),
    the engine put back where it was."""
    graph, _ = eng._graphs[key]
    snap = engine_snapshot(eng)
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    engine_restore(eng, snap)
    return statistics.median(times)


def greedy_futures(eng, params32, cfg, dev, n_future: int) -> dict:
    """The dense f32 greedy continuation, ``n_future`` tokens, of each
    active greedy slot's history (its token buffer up to its length, then
    its last token) on the probe engine: the table [S, n_future], the
    history lengths [S] and the greedy slots [S] on the card, and per slot
    the continuation with its top-2 gaps."""
    st = eng._dev
    n_rows = st["tok_buf"].shape[0]
    buf = st["tok_buf"].cpu()
    seq, last = st["seq_lens"].tolist(), st["last_tokens"].tolist()
    greedy = (st["active"] & (st["temps"] <= 0)).tolist()
    table = torch.zeros((n_rows, n_future), dtype=torch.int32)
    hist_len = torch.zeros((n_rows,), dtype=torch.int32)
    cont: dict = {}
    per_slot = {}
    for s_ in (i for i in range(n_rows) if greedy[i]):
        hist = buf[s_, :seq[s_]].tolist() + [last[s_]]
        if tuple(hist) not in cont:
            toks, gaps = list(hist), []
            for _ in range(n_future):
                row = dense_f32_rows(params32, cfg, toks, [0], dev)[0]
                top2 = row.topk(2)
                gaps.append(float(top2.values[0] - top2.values[1]))
                toks.append(int(top2.indices[0]))
            cont[tuple(hist)] = (toks[len(hist):], np.array(gaps))
        per_slot[s_] = cont[tuple(hist)]
        table[s_] = torch.tensor(per_slot[s_][0], dtype=torch.int32)
        hist_len[s_] = len(hist)
    return dict(table=table.to(dev), hist_len=hist_len.to(dev),
                greedy=torch.tensor(greedy, device=dev), per_slot=per_slot)


def forced_verify_gates(seen, props, fut, params32, cfg, dev, m) -> dict:
    """The eager spec dispatch with the greedy slots' drafts forced to the
    dense f32 greedy continuation (``fut``). Gates: every round accepts
    drafts on the greedy slots; each verify row ``i`` (``0 <= i < m``:
    prompt + history + the first ``i`` drafts, so K2 reads the K/V that
    the fused prologue wrote for the same slot's earlier rows in that
    layer) holds its logprobs of the f32 best token and of the draft within
    ``DENSE_LOGP_TOL`` of the dense f32 forward, and each emitted token's
    f32 logprob is within it of the best; each greedy slot's emitted
    tokens over the rounds equal the f32 greedy continuation or part from
    it at a near-tie."""
    slots = sorted(fut["per_slot"])
    accepted, err, worst_gap = [], 0.0, 0.0
    emitted = {s_: [] for s_ in slots}
    dense: dict = {}
    for (logits, _t, _p, _k, _uf, toks, _lps, n_acc), (buf, hl, draft) in zip(seen, props):
        accepted.append(int(n_acc[slots].sum()))
        lsm_eng = torch.log_softmax(logits.float(), dim=-1)
        for s_ in slots:
            hist = buf[s_, :int(hl[s_])].tolist()
            d = draft[s_].tolist()
            key = tuple(hist + d)
            if key not in dense:
                dense[key] = dense_f32_rows(params32, cfg, hist, d + [0], dev)
            ref = dense[key]
            for i in range(m):
                want = [int(ref[i].argmax())] + d[i:i + 1]
                t = torch.tensor(want, device=dev)
                err = max(err, (lsm_eng[s_, i, t] - ref[i, t]).abs().max().item())
            for i in range(int(n_acc[s_]) + 1):
                tok = int(toks[s_, i])
                worst_gap = max(worst_gap, (ref[i].max() - ref[i, tok]).item())
                emitted[s_].append(tok)
    # a first round that accepts advances each slot by several tokens, whose
    # K/V the second round's rows read
    check(len(accepted) == SPEC_ROUNDS and accepted[0] > 0,
          f"spec: forced drafts accepted on the greedy slots per round {accepted}")
    check(err <= DENSE_LOGP_TOL and worst_gap <= DENSE_LOGP_TOL,
          f"spec: forced verify rows {err:.4f} / {worst_gap:.4f} nats from the "
          f"dense f32 forward")
    parts = []
    for s_ in slots:
        ref_toks, gaps = fut["per_slot"][s_]
        got = emitted[s_]
        ok, first, _tie, gap = agrees_until_tie(got, ref_toks[:len(got)], gaps)
        check(ok, f"spec: forced slot {s_} parts from the f32 greedy run at "
                  f"{first} (top-2 gap {gap:.4f})")
        parts.append((first, len(got)))
    return dict(accepted=accepted, ceiling=len(slots) * (m - 1), err=err,
                gap=worst_gap, parts=parts)


def spec_graph_checks(dev, params, cfg, params32) -> dict:
    """The spec dispatch (key ``("spec", True, 5, 2)``) on the probe engine,
    with the greedy slots' drafts forced to the dense f32 greedy
    continuation (at random weights prompt lookup proposes what the model
    rejects, and verify rows past the first would go unchecked): a replay
    bitwise its eager body from one snapshot (tokens, logprobs, done,
    emitted, state with the token buffer, pools); ``forced_verify_gates``
    on the eager run; the sampled rows' emitted tokens inside their
    filtered sets (the verify sampler's own logits, from the eager run);
    the device ms of a spec dispatch against the plain 8-step dispatch on a
    twin engine at the same state, and the tokens each emitted."""
    import polyrl_tpu_torch.rollout.cb_engine as cbe
    from polyrl_tpu_torch.rollout import sampling

    eng = spec_probe_engine(dev, params, cfg, SPEC_TOKENS)
    m = SPEC_TOKENS + 1
    key = eng._spec_key(True)
    body = lambda: eng._spec_body(True)  # noqa: E731
    n_future = SPEC_ROUNDS * m + 1
    fut = greedy_futures(eng, params32, cfg, dev, n_future)
    seen, props, rec = [], [], {"on": False}
    propose, verify = cbe.device_ngram_propose, cbe.spec_verify_sample_vec

    def forced(tok_buf, hist_len, n_draft):
        off = ((hist_len - fut["hist_len"]).long()[:, None]
               + torch.arange(n_draft, device=dev)[None])
        use = fut["greedy"][:, None] & (off >= 0) & (off < n_future)
        draft = torch.where(use, fut["table"].gather(1, off.clamp(0, n_future - 1)),
                            propose(tok_buf, hist_len, n_draft)).to(torch.int32)
        if rec["on"]:
            props.append((tok_buf.clone(), hist_len.clone(), draft.clone()))
        return draft

    def recording(logits, draft, gen, temps, top_ps, top_ks, use_filters=True):
        out = verify(logits, draft, gen, temps, top_ps, top_ks, use_filters)
        if rec["on"]:
            seen.append((logits, temps, top_ps, top_ks, use_filters) + out)
        return out

    cbe.device_ngram_propose = forced
    cbe.spec_verify_sample_vec = recording
    try:
        eng._graphs.pop(key, None)  # captured at setup with plain lookup
        snap = engine_snapshot(eng)
        eng._launch(key, body)  # the eager dispatch, then the capture
        engine_restore(eng, snap)
        eng._launch(key, body)
        graph_out, graph_state = engine_outputs(eng)
        engine_restore(eng, snap)
        rec["on"] = True
        eng._spec_body(True)
        rec["on"] = False
        eager_out, eager_state = engine_outputs(eng)
        engine_restore(eng, snap)
        same = [torch.equal(a, b) for a, b in zip(graph_out, eager_out)]
        check(all(same) and states_equal(graph_state, eager_state),
              f"spec: the replay differs from the eager body ({same})")
        forced_res = forced_verify_gates(seen, props, fut, params32, cfg, dev, m)
        spec_ms = replay_ms(eng, key)
    finally:
        cbe.device_ngram_propose = propose
        cbe.spec_verify_sample_vec = verify
    outside, rows = 0, 0
    for logits, temps, top_ps, top_ks, uf, toks, _lps, n_acc in seen:
        s, m_, v = logits.shape
        rep = lambda a: a.repeat_interleave(m_, dim=0)  # noqa: E731
        scaled = sampling._filtered_scaled(
            logits.reshape(s * m_, v), rep(temps), rep(top_ps), rep(top_ks),
            uf).reshape(s, m_, v)
        kept = scaled.gather(-1, toks.long()[:, :, None])[:, :, 0] > sampling.NEG_INF
        emitted = torch.arange(m_, device=dev)[None] <= n_acc[:, None]
        sampled_rows = (snap[0]["active"] & (temps > 0))[:, None] & emitted
        rows += int(sampled_rows.sum())
        outside += int((sampled_rows & ~kept).sum())
    check(rows > 0 and outside == 0,
          f"spec: {outside} of {rows} sampled tokens outside their filtered sets")
    emitted = int(graph_out[3].sum())
    del eng, seen, props
    plain = spec_probe_engine(dev, params, cfg, 0)
    tables = plain._decode_group_pack()
    pkey = plain._graph_key(True, tables)
    if pkey not in plain._graphs:
        psnap = engine_snapshot(plain)
        plain._launch_decode(True, tables)
        engine_restore(plain, psnap)
    plain_ms = replay_ms(plain, pkey)
    plain_tokens = int(plain._active.sum()) * plain.steps_per_dispatch
    del plain
    return dict(spec_ms=spec_ms, spec_tokens=emitted, plain_ms=plain_ms,
                plain_key=str(pkey), plain_tokens=plain_tokens, rows=rows,
                forced=forced_res)


def spec_checks(dev, s1, cfg, params32) -> dict:
    """``spec_tokens`` 4, ``spec_rounds`` 2 on the serve phase's mix plus a
    repetitive greedy prompt, through a second server; the mix in turns on
    both servers. Gates: greedy streams equal the plain engine's or part
    from it at a near-tie, within ``DENSE_LOGP_TOL`` of the dense f32
    forward (``params32``); launches from zero over the first spec run: the fused prologue and K2,
    no K3; then ``spec_graph_checks``."""
    from polyrl_tpu_torch.rollout.serve import create_server

    bodies, greedy_prompts, _ = serving_mix(cfg.vocab_size)
    rng = np.random.default_rng(24)
    rep_prompt = rng.integers(1, cfg.vocab_size, 16).tolist() * 8
    bodies = bodies + [{"rid": "rep", "input_ids": rep_prompt,
                        "sampling_params": {"temperature": 0.0,
                                            "max_new_tokens": 128}}]
    s2 = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                       spec_tokens=SPEC_TOKENS, spec_rounds=SPEC_ROUNDS,
                       **FEATURE_ENGINE)
    try:
        eng2 = s2.engine
        runs = {"spec": [], "plain": []}
        launches = None
        for turn, srv in (("spec", s2), ("plain", s1), ("spec", s2),
                          ("plain", s1)):
            e0 = (eng2.spec_emitted, eng2.spec_token_ceiling)
            if launches is None:
                cuda_build.reset_launch_counts()
            outs, info0, info = run_mix(srv.port, bodies, f"{turn}{len(runs[turn])}")
            if launches is None:
                launches = dict(cuda_build.LAUNCHES)
            accept = ((eng2.spec_emitted - e0[0])
                      / max(eng2.spec_token_ceiling - e0[1], 1))
            runs[turn].append(dict(outs=outs, tok_s=mix_tok_s(outs),
                                   ttft=[o["lines"][0][0] - o["t0"] for o in outs],
                                   accept=accept if turn == "spec" else None))
        check(launches["paged_kv_write_fused"] > 0 and launches["paged_attention"] > 0
              and launches["grouped_paged_attention"] == 0
              and launches["paged_kv_write"] == 0,
              f"spec: launches of the spec mix {json.dumps(launches)}")
        by_rid = lambda outs: {b["rid"]: o for b, o in zip(bodies, outs)}  # noqa: E731
        spec_o, plain_o = by_rid(runs["spec"][0]["outs"]), by_rid(runs["plain"][0]["outs"])
        worst = {}
        for rid, prompt in (("greedy0", greedy_prompts[0]),
                            ("greedy1", greedy_prompts[1]), ("rep", rep_prompt)):
            ref = plain_o[rid]["tokens"]
            gaps = top2_gaps(params32, cfg, prompt, ref, dev)
            ok, first, tie, tgap = agrees_until_tie(spec_o[rid]["tokens"], ref, gaps)
            check(ok, f"spec: {rid} parts from the plain engine at {first} "
                      f"(top-2 gap {tgap:.4f}), first near-tie {tie}")
            err, gap = dense_f32_gate(params32, cfg, prompt, spec_o[rid]["tokens"],
                                      spec_o[rid]["logprobs"], dev)
            check(err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
                  f"spec: {rid} {err:.4f} / {gap:.4f} nats from the dense f32 forward")
            worst[rid] = (round(err, 4), round(gap, 4), first, tie, round(tgap, 4))
        graphs = spec_graph_checks(dev, eng2.params, cfg, params32)
        return dict(runs=runs, launches=launches, worst=worst, graphs=graphs,
                    accept_all=eng2.spec_accept_rate,
                    spec_dispatches=eng2.spec_dispatches)
    finally:
        s2.stop()


def warm_release_checks(dev, s1, cfg, serve_ttft) -> dict:
    """Through the served engine's server: a greedy request; then
    ``/release_memory_occupation`` (at least ``RELEASE_MIN_GB`` freed) and
    ``/resume_memory_occupation``; ``warmup()`` on the resumed engine (the
    ungrouped decode graphs captured up front); the serve mix, which
    captures no ungrouped key (its GRPO groups' grouped keys are captured
    at their first dispatch, and logged); the greedy request again,
    bitwise the one before the release."""
    port, eng = s1.port, s1.engine
    bodies, greedy_prompts, _ = serving_mix(cfg.vocab_size)
    req = {"rid": "same", "input_ids": greedy_prompts[0],
           "sampling_params": {"temperature": 0.0, "max_new_tokens": 64}}
    post(port, "/flush_cache", {})
    before = run_requests(port, [req])[0]
    torch.cuda.synchronize(dev)
    m0 = torch.cuda.memory_allocated(dev)
    post(port, "/release_memory_occupation", {})
    torch.cuda.synchronize(dev)
    freed = (m0 - torch.cuda.memory_allocated(dev)) / 1e9
    check(freed >= RELEASE_MIN_GB and eng._graphs == {},
          f"release freed {freed:.2f} GB, {len(eng._graphs)} graphs kept")
    post(port, "/resume_memory_occupation", {})
    regained = (torch.cuda.memory_allocated(dev) - m0) / 1e9
    t0 = time.monotonic()
    eng.warmup()
    warm_s = time.monotonic() - t0
    warmed, capture_s = set(eng._graphs), eng.graph_capture_s
    outs, info0, info = run_mix(port, bodies, "warm")
    later = [k for k in eng._graphs if k not in warmed]
    check(all(k[2] is not None for k in later),
          f"the mix after warmup captured ungrouped keys {later}")
    post(port, "/flush_cache", {})
    after = run_requests(port, [dict(req, rid="same-again")])[0]
    check(after["tokens"] == before["tokens"]
          and after["logprobs"] == before["logprobs"],
          "the greedy request after resume differs from the one before release")
    ttft = [o["lines"][0][0] - o["t0"] for o in outs]
    return dict(freed_gb=freed, regained_gb=regained, warm_s=warm_s,
                warm_captures=len(warmed), later=[k[2] for k in later],
                later_s=eng.graph_capture_s - capture_s, ttft=ttft,
                serve_ttft=serve_ttft, tok_s=mix_tok_s(outs))


def features_phase(dev, serve_ttft: list) -> dict:
    """salvage, chunked prefill, speculation, warmup and release on
    ``qwen3-1.7b`` at full width and depth (bf16, weights from seed 0; 64
    slots, page 64, 2,048 pages, run-ahead depth 16), each step's wall
    logged."""
    from polyrl_tpu_torch.rollout.serve import create_server

    s1 = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                       **FEATURE_ENGINE)
    out: dict = {}
    try:
        cfg = s1.engine.cfg
        p32 = f32_copy(s1.engine.params)
        walls = {}
        for name, fn in (
                ("salvage", lambda: salvage_checks(s1.engine, cfg, dev, p32)),
                ("chunked", lambda: chunk_checks(s1.engine, cfg, dev, p32)),
                ("spec", lambda: spec_checks(dev, s1, cfg, p32)),
                ("warm_release", lambda: warm_release_checks(dev, s1, cfg,
                                                             serve_ttft))):
            t0 = time.monotonic()
            out[name] = fn()
            walls[name] = time.monotonic() - t0
            gc.collect()
            torch.cuda.empty_cache()
        out["walls"] = walls
    finally:
        s1.stop()
    eng = s1.engine
    check(eng.allocator.free_count == eng.num_pages - 1,
          f"{eng.num_pages - 1 - eng.allocator.free_count} pages held after stop()")
    return out


def features_lines(f: dict, smi: str) -> list[str]:
    s, c, sp, w = f["salvage"], f["chunked"], f["spec"], f["warm_release"]
    med = lambda xs: statistics.median(xs) * 1e3  # noqa: E731
    lines = [
        f"features salvage ({smi}, this run): aborted after 5 tokens, "
        f"{s['k']} tokens delivered = 1 + {s['n_disp']} dispatches x 8; "
        f"tokens_salvaged {s['salvaged']}; {s['published']} pages published, "
        f"the continuation hit {s['hit_pages']}; stitched stream equal to the "
        f"uninterrupted run up to {s['first']} (top-2 f32 gap there "
        f"{s['gap']:.4f}; first near-tie {s['tie']}), vs dense f32 "
        f"{s['dense'][0]:.4f} / {s['dense'][1]:.4f} nats; "
        f"abort-to-terminal ms, in turns: salvage on "
        f"{[round(x * 1e3, 1) for x in s['latency_on']]}, off "
        f"{[round(x * 1e3, 1) for x in s['latency_off']]}",
        f"features chunked ({smi}, this run): 3000-token prompt, first-token "
        f"logprob chunked vs whole {c['d_lp']:.4f} nats, greedy equal up to "
        f"{c['first']} (top-2 f32 gap there {c['gap']:.4f}; first near-tie "
        f"{c['tie']}), chunked vs dense f32 {c['dense'][0]:.4f} / "
        f"{c['dense'][1]:.4f} nats; peak memory over the "
        f"admission chunked {c['peak_chunked']:.2f} GB, whole "
        f"{c['peak_whole']:.2f} GB; 16 live streams during the admission: "
        f"chunked {c['live'][512]['tok_s']:.1f} tok/s over "
        f"{c['live'][512]['admit_s'] * 1e3:.1f} ms (decode dispatches at the "
        f"chunks {c['live'][512]['marks']}), whole "
        f"{c['live'][0]['tok_s']:.1f} tok/s over "
        f"{c['live'][0]['admit_s'] * 1e3:.1f} ms",
        f"features spec ({smi}, this run): spec_tokens {SPEC_TOKENS}, rounds "
        f"{SPEC_ROUNDS}; mix of 19 streams in turns tok/s spec "
        f"{[round(r['tok_s'], 1) for r in sp['runs']['spec']]} vs plain "
        f"{[round(r['tok_s'], 1) for r in sp['runs']['plain']]}; acceptance "
        f"{[round(r['accept'], 4) for r in sp['runs']['spec']]} (all "
        f"{sp['accept_all']:.4f}); TTFT median spec "
        f"{med(sp['runs']['spec'][0]['ttft']):.1f} ms, plain "
        f"{med(sp['runs']['plain'][0]['ttft']):.1f} ms; greedy vs plain and "
        f"dense f32 (err, gap, first mismatch, first near-tie, top-2 f32 gap "
        f"at the mismatch) {json.dumps(sp['worst'])}; forced drafts (the f32 "
        f"greedy continuation) on the probe's greedy slots: accepted per "
        f"round {sp['graphs']['forced']['accepted']} of "
        f"{sp['graphs']['forced']['ceiling']}, verify rows vs dense f32 "
        f"{sp['graphs']['forced']['err']:.4f} / {sp['graphs']['forced']['gap']:.4f} "
        f"nats, (first mismatch, emitted) per slot "
        f"{sp['graphs']['forced']['parts']}; launches of the first spec mix "
        f"{json.dumps(sp['launches'])}; device ms per dispatch (19 live "
        f"slots): spec (forced drafts) {sp['graphs']['spec_ms']:.3f} ms for "
        f"{sp['graphs']['spec_tokens']} tokens, plain {sp['graphs']['plain_key']} "
        f"{sp['graphs']['plain_ms']:.3f} ms for {sp['graphs']['plain_tokens']} "
        f"tokens; sampled verify rows checked {sp['graphs']['rows']}",
        f"features warmup/release ({smi}, this run): release freed "
        f"{w['freed_gb']:.2f} GB, resume took back {w['regained_gb']:.2f} GB; "
        f"warmup {w['warm_s']:.1f} s, {w['warm_captures']} graphs captured, "
        f"the mix after it no ungrouped key, {len(w['later'])} grouped keys "
        f"{w['later']} in {w['later_s']:.2f} s, {w['tok_s']:.1f} tok/s, TTFT median "
        f"{med(w['ttft']):.1f} ms (serve phase {med(w['serve_ttft']):.1f} ms), "
        f"max {max(w['ttft']) * 1e3:.1f} ms (serve phase "
        f"{max(w['serve_ttft']) * 1e3:.1f} ms); greedy after resume bitwise",
        f"features walls ({smi}, this run): "
        + json.dumps({k: round(v, 1) for k, v in f["walls"].items()}),
    ]
    return lines


# -- phase 10: the step backend (step) ------------------------------------------

STEP_STREAMS, STEP_PROMPT, STEP_NEW = 16, 128, 256
# the step backend's GRPO step: responses of this many tokens (the training
# cell's 448 until PR 17: its generation took 24.3 s of the smoke's budget)
STEP_FIT_RESPONSE = 128
STEP_KERNELS = ("flash_attention_fwd", "flash_attention_bwd")


def step_phase(dev) -> dict:
    """``RolloutEngine.generate`` on 16 seeded prompts of 128 tokens x 256
    new tokens, greedy, against ``CBEngine`` on the same requests (in
    the same call): the same tokens up to the first near-tie, logprobs within
    ``DENSE_LOGP_TOL`` of the dense f32 forward, tok/s of each. A server
    with ``backend="step"`` streams the tokens its engine's ``generate``
    gives. Then one GRPO step through ``build_trainer`` with
    ``rollout.backend=step`` at the train phase's configuration."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.engine import RolloutEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.serve import create_server
    from polyrl_tpu_torch.train import build_trainer

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = decoder.init_params(gen, cfg)
    rng = np.random.default_rng(23)
    prompts = [rng.integers(1, cfg.vocab_size, STEP_PROMPT).tolist()
               for _ in range(STEP_STREAMS)]
    sp = SamplingParams(temperature=0.0, max_new_tokens=STEP_NEW)
    reng = RolloutEngine(cfg, params, batch_buckets=(STEP_STREAMS,),
                         prompt_buckets=(STEP_PROMPT,), device=dev)
    ceng = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                    num_pages=256, steps_per_dispatch=8, device=dev)
    walls = {"step": [], "cb": []}
    res = {}
    try:
        for name in ("step", "cb"):
            t0 = time.monotonic()
            if name == "step":
                got = reng.generate(prompts, sp)
                outs = [o.output_ids.tolist() for o in got]
                lps = [o.output_token_logprobs.tolist() for o in got]
            else:
                got = ceng.generate(prompts, sp, timeout=600.0)
                outs, lps = [o["token_ids"] for o in got], [o["logprobs"] for o in got]
            walls[name].append(time.monotonic() - t0)
            res[name] = (outs, lps)
    finally:
        ceng.stop()
    del ceng
    params32 = f32_copy(params)
    worst = (0.0, 0.0)
    ties = []
    for i, prompt in enumerate(prompts):
        gaps = top2_gaps(params32, cfg, prompt, res["cb"][0][i], dev)
        ok, first, tie, gap = agrees_until_tie(res["step"][0][i], res["cb"][0][i],
                                               gaps)
        check(ok, f"step: stream {i} parts from the CB engine at {first} "
                  f"(top-2 gap {gap:.4f}), first near-tie {tie}")
        ties.append((first, tie, round(gap, 4)))
        err, gap = dense_f32_gate(params32, cfg, prompt, res["step"][0][i],
                                  res["step"][1][i], dev)
        check(err <= DENSE_LOGP_TOL and gap <= DENSE_LOGP_TOL,
              f"step: stream {i} {err:.4f} / {gap:.4f} nats from the dense f32 forward")
        worst = (max(worst[0], err), max(worst[1], gap))
    del params32, reng
    gc.collect()
    torch.cuda.empty_cache()

    srv = create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                        backend="step", batch_buckets=(STEP_STREAMS,),
                        prompt_buckets=(STEP_PROMPT,), seed=0)
    try:
        body = {"rid": "step0", "input_ids": prompts[0],
                "sampling_params": {"temperature": 0.0, "max_new_tokens": 64}}
        served = run_requests(srv.port, [body])[0]
        want = srv.engine.generate([prompts[0]], SamplingParams(
            temperature=0.0, max_new_tokens=64))[0]
        check(served["tokens"] == want.output_ids.tolist(),
              "step: the server's stream differs from the engine's generate")
        info = post(srv.port, "/get_server_info", None)
        check(info["backend"] == "step", "step: the server is not the step backend")
    finally:
        srv.stop()
    del srv, params
    gc.collect()
    torch.cuda.empty_cache()

    tcfg = load_config(None, TRAIN_OVERRIDES + [
        "rollout.backend=step", f"rollout.batch_buckets={STEP_STREAMS}",
        f"trainer.max_response_length={STEP_FIT_RESPONSE}",
        "trainer.total_steps=1"])
    cleanup: list = []
    torch.cuda.reset_peak_memory_stats(dev)
    trainer = build_trainer(tcfg, cleanup, compute_score=byte_length_score)
    try:
        check(isinstance(trainer.rollout, RolloutEngine),
              "rollout.backend=step did not build the step engine")
        cuda_build.reset_launch_counts()
        history = trainer.fit()
        launches = dict(cuda_build.LAUNCHES)
    finally:
        for fn in cleanup:
            fn()
    check(len(history) == 1, "the step-backend fit did not run its step")
    rec = history[0]
    for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
        check(key in rec and np.isfinite(rec[key]),
              f"step fit: {key} missing or not finite")
    check(rec["actor/grad_norm"] > 0, "step fit: zero gradient")
    for name in STEP_KERNELS:
        check(launches[name] > 0, f"{name} was not launched in the step fit")
    # one push at the build and one after the step
    check(trainer.rollout.weight_version == 2, "step fit: weight_version != 2")
    n_tok = STEP_STREAMS * STEP_NEW
    return dict(tok_s={k: [n_tok / w for w in v] for k, v in walls.items()},
                worst=worst, ties=ties, launches=launches,
                step_walls=[rec["perf/step_time_s"]],
                gen_walls=[rec.get("timing_s/gen", float("nan"))],
                peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9)


# the disagg phase: the rollout server's own KV pool (7.34 MB a page at
# full width: 3.76 GB), its geometry the train phase's engine's
DISAGG_PAGES = 512
# extra command-line arguments of the manager that the disagg and autoscale
# phases spawn (``--manager-args``; e.g. ``--max-assigned-batches 16``)
MANAGER_ARGS: list[str] = []
DISAGG_SERVER = ["--max-slots", "64", "--page-size", "64", "--max-seq-len",
                 "512", "--prompt-buckets", "64", "128",
                 "--steps-per-dispatch", "8"]
# a rollout server subprocess: ``serve.main`` on the arguments after
# ``-c``, the model cut to this many layers (``%`` fills it in)
SERVE_MAIN = ("import sys; from polyrl_tpu_torch.rollout import serve; "
              "serve.main(sys.argv[1:], model_overrides={'num_layers': %d})")
DISAGG_GREEDY = 64
DISAGG_SERVER_DEADLINE_S = 300.0
# the int8 server that joins after the fit for one push: a small pool
DISAGG_INT8_PAGES = 64
# the rollout server's state polled through the fit, every this many s
TIMELINE_POLL_S = 0.05


def free_port() -> int:
    import socket

    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        return s_.getsockname()[1]


def _tail(path: str, n: int = 3000) -> str:
    with open(path, "rb") as f:
        return f.read()[-n:].decode(errors="replace")


def spawn_server(dev, mgr, manager_ep: str | None, extra: list[str],
                 procs: list, port: int | None = None) -> tuple[int, str, float]:
    """``serve.main`` on ``serve``'s command line, ``MODEL`` at
    REMOTE_CUT_LAYERS layers (its ``model_overrides``; the command line
    takes no depth), as a subprocess registered through ``--manager-endpoint`` (appended to ``procs``
    at once, so teardown stops it), waited for until the manager reports
    it healthy. With ``manager_ep`` None it joins no pool (something must
    add it by its endpoint) and is waited for until its own
    ``/health_generate`` answers. Returns its port, its log's path and the
    seconds it took."""
    port = port or free_port()
    endpoint = f"127.0.0.1:{port}"
    join = (["--manager-endpoint", manager_ep, "--transfer-streams", "4"]
            if manager_ep else [])
    log_path = tempfile.NamedTemporaryFile(prefix="disagg-server-",
                                           suffix=".log", delete=False).name
    env = dict(os.environ)
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.monotonic()
    with open(log_path, "wb") as f:
        proc = subprocess.Popen(
            [sys.executable, "-c", SERVE_MAIN % REMOTE_CUT_LAYERS,
             "--model", MODEL, "--dtype", "bfloat16",
             "--device", dev.type, "--host", "127.0.0.1", "--port", str(port),
             "--seed", "0"]
            + join + DISAGG_SERVER + extra,
            cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT)
    procs.append((proc, port, log_path))
    while True:
        check(proc.poll() is None, "a rollout server exited "
              f"(rc {proc.returncode}): {_tail(log_path)}")
        if (any(i["endpoint"] == endpoint and i["healthy"]
                for i in mgr.get_instances_status()["instances"])
                if manager_ep else serving(port)):
            return port, log_path, time.monotonic() - t0
        check(time.monotonic() - t0 < DISAGG_SERVER_DEADLINE_S,
              f"a rollout server never became healthy: {_tail(log_path)}")
        time.sleep(0.5)


def serving(port: int, path: str = "/health_generate") -> bool:
    """Whether a server on ``port`` answers ``path`` with 200 (``/health``:
    whether its listener is still up)."""
    try:
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=5)
        conn.request("GET", path)
        ok = conn.getresponse().status == 200
        conn.close()
        return ok
    except OSError:
        return False


def stream_timeline(streams: list, timeline: list, syncs: dict) -> list[dict]:
    """Each streamed step's generation as the server saw it: ``streams``
    holds (start, end, version) on the wall clock, ``timeline`` the
    server's (time, weight_version, running, queued, tokens served,
    graph captures, capture s, decode dispatches) polled through the fit,
    ``syncs`` its weight installs by version. Per stream: when the server
    raised the stream's version, admitted its first request, reached its
    most running requests, emitted its first and last token (to the
    poll's resolution), and the tokens, tok/s, decode dispatches and graph
    captures between; ``tail_s`` runs from the last token to the last
    chunk's arrival in the trainer."""
    out = []
    for s0, s1, v in streams:
        rows = [r for r in timeline if s0 - TIMELINE_POLL_S <= r[0] <= s1 + TIMELINE_POLL_S]
        if len(rows) < 2:
            out.append(dict(stream_s=s1 - s0, tokens=0))
            continue
        tok0, tok1 = rows[0][4], rows[-1][4]
        first_tok = next((r[0] for r in rows if r[4] > tok0), s1)
        last_tok = next((r[0] for r in rows if r[4] >= tok1), s1)
        admit = next((r[0] for r in rows if r[2] + r[3] > 0), first_tok)
        peak = max(r[2] for r in rows)
        full = next(r[0] for r in rows if r[2] == peak)
        busy = max(last_tok - first_tok, TIMELINE_POLL_S)
        out.append(dict(
            peak_running=peak, full_s=full - s0,
            dispatches=rows[-1][7] - rows[0][7],
            stream_s=s1 - s0,
            raised_s=syncs.get(v, {}).get("t_wall", float("nan")) - s0,
            admit_s=admit - s0, first_tok_s=first_tok - s0,
            last_tok_s=last_tok - s0, tail_s=s1 - last_tok,
            tokens=tok1 - tok0, tok_s=(tok1 - tok0) / busy,
            captures=rows[-1][5] - rows[0][5],
            capture_s=rows[-1][6] - rows[0][6]))
    return out


def disagg_phase(dev, trained: dict) -> dict:
    """The disaggregated rollout: the port's C++ manager built by ``g++``
    and spawned supervised; the rollout server a subprocess
    (``spawn_server``: ``serve.main`` on ``qwen3-1.7b``, bf16, 512 pages,
    registered through ``--manager-endpoint``); the trainer ``build_trainer`` with
    ``rollout.mode=disaggregated`` and the train phase's configuration;
    both at REMOTE_CUT_LAYERS layers.
    Gates: finite losses, grad norms > 0; every push verified (no push or
    verify failure, no retry) and the server's ``weight_version`` at 1 +
    the steps; every streamed token tagged with the version its stream
    started at (the serial trainer's staleness limit 1); a GRPO group of 8
    on a 64-token prompt through the manager; a greedy request through the
    manager after the last push equal to an in-process ``CBEngine`` on the
    trainer's final parameters (or parting only at a near-tie, as
    ``agrees_until_tie``), its logprobs within DENSE_LOGP_TOL of the dense
    f32 forward; launches counted from zero: the fused prologue, K2 and K3
    in the server process, K4 forward and backward in the trainer's, and
    no decode kernel in the trainer's. Logs each push split into pack,
    wire, install and swap, the version-raise latency, the step walls
    against the train phase's colocated ones, the bubble,
    ``max_local_gen_s`` and each process's peak memory, and each step's
    generation as the server saw it (its state polled every
    TIMELINE_POLL_S: the version's raise, the first admission, the first
    and last token, tok/s, graph captures). Then ``disagg_int8_push``."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.manager.client import GenerateProgress
    from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.train import build_trainer

    t0 = time.monotonic()
    sup = ManagerSupervisor(bind_addr="127.0.0.1:0", extra_args=[
        "--health-check-interval-s", "0.5", "--stats-poll-interval-s", "0.5"]
        + MANAGER_ARGS)
    sup.start()
    mgr_s = time.monotonic() - t0
    cleanup: list = [sup.stop]
    procs: list = []
    try:
        cfg = load_config(None, REMOTE_OVERRIDES + [
            "rollout.mode=disaggregated",
            f"rollout.manager_endpoint={sup.endpoint}",
            "rollout.transfer_streams=4", f"device={dev.type}"])
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        remote, iface = trainer.rollout, trainer.rollout.transfer
        # the server starts after the trainer registered its weight sender,
        # so the manager assigns it and its receiver connects there
        mgr = remote.manager
        port, server_log, server_up_s = spawn_server(
            dev, mgr, sup.endpoint, ["--num-pages", str(DISAGG_PAGES)], procs)
        proc = procs[0][0]
        info0 = post(port, "/get_server_info", None)
        log(f"disagg: manager built and supervised in {mgr_s:.1f} s; trainer "
            f"up; rollout server (a subprocess, {DISAGG_PAGES} pages) healthy "
            f"after {server_up_s:.1f} s; its launches before the fit "
            + json.dumps({k_: info0[f"kernel_launches/{k_}"] for k_ in SERVE_KERNELS}))

        # every streamed result, with the weight version at its stream's
        # start; each stream's start and its last chunk's arrival on the
        # wall clock (the trainer works on a chunk before it asks for the
        # next, so the generator's own end is later)
        streamed: list[tuple[int, object]] = []
        streams: list[list] = []
        inner = remote.generate_stream

        def recording_stream(*a, **kw):
            start = remote.weight_version
            span = [time.time(), time.time(), start]
            streams.append(span)
            for chunk in inner(*a, **kw):
                streamed.extend((start, r) for _, r in chunk)
                span[1] = time.time()
                yield chunk

        # the server's state through the fit, for each step's generation
        # as the server saw it
        timeline: list[tuple] = []
        # the server's flight-deck occupancy and loop-profiler device_frac
        # through the fit (what the manager's stats poll forwards)
        feed: list[tuple] = []
        poll_err: list[BaseException] = []
        polled = threading.Event()

        def poll_server():
            try:
                while not polled.is_set():
                    inf = post(port, "/get_server_info", None)
                    timeline.append((time.time(), inf["weight_version"],
                                     inf["num_running_reqs"], inf["num_queued_reqs"],
                                     inf["total_tokens_served"], inf["graph_captures"],
                                     inf["graph_capture_s"], inf["decode_dispatches"]))
                    feed.append((time.time(), inf.get("occupancy"),
                                 inf.get("device_frac")))
                    polled.wait(TIMELINE_POLL_S)
            except BaseException as exc:  # noqa: BLE001 -- checked below
                poll_err.append(exc)

        remote.generate_stream = recording_stream
        poller = threading.Thread(target=poll_server, name="disagg-poll", daemon=True)
        poller.start()
        cuda_build.reset_launch_counts()
        t2 = time.monotonic()
        try:
            history = trainer.fit()
        finally:
            polled.set()
            poller.join(timeout=30)
        fit_wall = time.monotonic() - t2
        remote.generate_stream = inner
        check(not poll_err, f"disagg: polling the server failed: {poll_err}")
        n_steps = cfg.trainer.total_steps
        check(len(history) == n_steps, "the disaggregated fit did not finish")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"disagg step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0, f"disagg step {i}: zero gradient")
            check("training/max_local_gen_s" in rec,
                  f"disagg step {i}: no balancer answer")
            # the servers' reports, aggregated by the pool
            check(rec.get("engine/occupancy", 0.0) > 0.0
                  and "engine/device_frac" in rec,
                  f"disagg step {i}: the pool has no engine/occupancy or "
                  f"engine/device_frac")
        check(all(o is not None and d is not None for _, o, d in feed),
              "disagg: the server does not report occupancy and device_frac")
        # what reached the balancer: each step's observation carries the
        # previous record's fleet aggregates (the first step's are 0)
        seen = list(remote.balance._steps)
        check([s_["occupancy"] for s_ in seen][1:]
              == [rec["engine/occupancy"] for rec in history[:-1]]
              and [s_["device_frac"] for s_ in seen][1:]
              == [rec["engine/device_frac"] for rec in history[:-1]],
              f"disagg: the balancer saw other occupancy/device_frac: {seen}")
        check(any(s_["occupancy"] > 0 for s_ in seen)
              and any(s_["device_frac"] > 0 for s_ in seen),
              f"disagg: no non-zero occupancy or device_frac reached the "
              f"balancer: {seen}")
        final = remote.weight_version
        check(final == 1 + n_steps, f"disagg: {final} pushes, not 1 + {n_steps}")
        t3 = time.monotonic()
        while post(port, "/get_server_info", None)["weight_version"] < final:
            check(proc.poll() is None, f"the rollout server exited: {_tail(server_log)}")
            check(time.monotonic() - t3 < 120, "the last push never landed")
            time.sleep(0.1)
        c = iface.counters()
        check(c["transfer/push_failures"] == 0 and c["transfer/verify_failures"] == 0
              and c["transfer/push_retries"] == 0,
              f"a push failed or was retried: {json.dumps(c)}")
        limit = cfg.trainer.staleness_limit
        stale = [(v0, r.output_token_weight_versions) for v0, r in streamed
                 if len(r.output_token_weight_versions) != len(r.output_token_ids)
                 or any(v < 0 or v0 - v > limit - 1 or v > v0
                        for v in r.output_token_weight_versions)]
        per_step = cfg.trainer.train_batch_size * cfg.trainer.rollout_n
        check(len(streamed) == n_steps * per_step and not stale,
              f"disagg: {len(streamed)} streamed results; untagged or stale "
              f"tokens in {len(stale)}")
        # a GRPO group through the manager on a full-page prompt (K3)
        rng = np.random.default_rng(2)
        vocab = trainer.actor.model_cfg.vocab_size
        # 100 tokens: one full page shared by the group (K3's prefix)
        group_prompt = rng.integers(1, vocab, 100).tolist()
        reqs = [{"rid": f"dg{i}", "input_ids": group_prompt, "group_id": "dgrp",
                 "group_size": 8, "sampling_params": {"temperature": 1.0,
                                                      "max_new_tokens": 64}}
                for i in range(8)]
        finals = [r for r in mgr.batch_generate_stream(reqs)
                  if not isinstance(r, GenerateProgress)]
        check(len(finals) == 8 and all(r.success and len(r.output_token_ids) == 64
                                       and set(r.output_token_weight_versions) == {final}
                                       for r in finals),
              "disagg: the GRPO group through the manager failed")
        greedy_prompt = rng.integers(1, vocab, 40).tolist()
        served = mgr.generate("dgreedy", greedy_prompt,
                              {"temperature": 0.0, "max_new_tokens": DISAGG_GREEDY})
        check(served.success, f"disagg greedy: {served.error}")
        info = post(port, "/get_server_info", None)
        planes = server_planes(port, "disagg")
        server_launches = {k_: info[f"kernel_launches/{k_}"] - info0[f"kernel_launches/{k_}"]
                           for k_ in SERVE_KERNELS}
        trainer_launches = dict(cuda_build.LAUNCHES)
        for name in SERVE_KERNELS:
            check(server_launches[name] > 0,
                  f"{name} was not launched in the server process: "
                  f"{json.dumps(server_launches)}")
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            check(trainer_launches[name] > 0, f"{name} was not launched in the trainer")
        check(all(trainer_launches[k_] == 0 for k_ in SERVE_KERNELS),
              f"the trainer process decoded: {json.dumps(trainer_launches)}")
        trainer_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        log(f"disagg: {len(streamed)} streamed results, every token tagged "
            f"with its stream's version; the GRPO group through the manager "
            f"and the greedy request at v{final}")

        # the same greedy request on an in-process engine with the trainer's
        # final parameters
        params = trainer.actor.export_params()
        mcfg = trainer.actor.model_cfg
        eng = CBEngine(mcfg, params, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
                       max_slots=64, page_size=64, max_seq_len=512,
                       num_pages=DISAGG_PAGES, steps_per_dispatch=8,
                       prompt_buckets=(64, 128), seed=0, device=dev)
        try:
            local = eng.generate([greedy_prompt], SamplingParams(
                temperature=0.0, max_new_tokens=DISAGG_GREEDY))[0]
        finally:
            eng.stop()
        del eng
        params32 = f32_copy(params)
        gaps = top2_gaps(params32, mcfg, greedy_prompt, local["token_ids"], dev)
        ok, first, tie, gap = agrees_until_tie(served.output_token_ids,
                                               list(local["token_ids"]), gaps)
        check(ok, f"disagg greedy: served tokens part from the in-process "
              f"engine's at {first} (first near-tie {tie}, f32 gap {gap:.4f})")
        err, _ = dense_f32_gate(params32, mcfg, greedy_prompt,
                                served.output_token_ids,
                                served.output_token_logprobs, dev)
        check(err <= DENSE_LOGP_TOL, f"disagg greedy: {err:.4f} nats from the "
              "dense f32 forward")
        del params32
        lp_same = served.output_token_logprobs == list(local["logprobs"])
        check(set(served.output_token_weight_versions) == {final},
              "disagg greedy: tokens of another weight version")
        syncs = {s_["version"]: s_ for s_ in info.get("weight_syncs", [])}
        rounds = {r_["version"]: r_ for r_ in iface.sender.round_log}
        pushes = []
        for pl in iface.push_log:
            v = pl["version"]
            sy, rd = syncs.get(v, {}), rounds.get(v, {})
            pushes.append(dict(version=v, bytes=sy.get("bytes", rd.get("bytes", 0)),
                               pack_s=pl["pack_s"], wire_s=rd.get("push_s", float("nan")),
                               install_s=sy.get("install_s", float("nan")),
                               swap_s=sy.get("swap_s", float("nan")),
                               raise_s=sy.get("t_wall", float("nan")) - pl["t_wall"]))
        check(sorted(p_["version"] for p_ in pushes) == list(range(1, final + 1)),
              f"disagg: push log {pushes}")
        gen = stream_timeline(streams, timeline, syncs)
        check(len(gen) == n_steps, f"disagg: {len(gen)} streams for {n_steps} steps")
        int8 = disagg_int8_push(dev, remote, iface, sup.endpoint, params, mcfg,
                                procs)
        plane_gates(history, "disagg")
        return dict(history=history, fit_wall=fit_wall, pushes=pushes,
                    gen=gen, int8=int8, feed=feed, streams=streams,
                    planes=planes,
                    balance=dict(seen=seen, trends=remote.balance.trends()),
                    server_launches=server_launches,
                    trainer_launches=trainer_launches, trainer_peak=trainer_peak,
                    server_peak=info.get("peak_memory_bytes", 0) / 1e9,
                    greedy=dict(bitwise=served.output_token_ids == list(local["token_ids"]),
                                logprobs_bitwise=lp_same, first=first, tie=tie,
                                gap=gap, dense_err=err),
                    server_up_s=server_up_s, manager_s=mgr_s,
                    colocated=[rec["perf/step_time_s"] for rec in trained["history"]],
                    colocated_dispatches=trained["decode_dispatches"],
                    colocated_gen=[(rec.get("timing_s/gen", float("nan")),
                                    rec.get("perf/rollout_throughput_tok_s", float("nan")))
                                   for rec in trained["history"]])
    finally:
        stop_servers(procs)
        for fn in reversed(cleanup):
            fn()


def disagg_int8_push(dev, remote, iface, manager_ep: str, params: dict, mcfg,
                     procs: list) -> dict:
    """An int8 server (``--weight-quant int8``) joins after the fit and
    takes one push of the trainer's final bf16 tree over the fabric: its
    receiver's layout comes from the bf16 template, and the push is
    re-quantized on arrival (``weight_preprocess``). Gates: the push
    verified and both servers at its version; a greedy request on the int8
    server equal to an in-process int8 ``CBEngine`` on
    ``quant.quantize_params`` of the same tree (or parting only at a
    near-tie of the dense f32 forward on the dequantized weights), within
    DENSE_LOGP_TOL of it."""
    from polyrl_tpu_torch.models import quant
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    port8, log8, up_s = spawn_server(
        dev, remote.manager, manager_ep,
        ["--weight-quant", "int8", "--num-pages", str(DISAGG_INT8_PAGES)], procs)
    port_bf16 = procs[0][1]
    v = remote.update_weights(params)
    t0 = time.monotonic()
    for p_ in (port8, port_bf16):
        # a server raises its version inside the swap and logs the install
        # just after it: wait for both
        while True:
            inf = post(p_, "/get_server_info", None)
            if inf["weight_version"] >= v and any(
                    s_["version"] >= v for s_ in inf.get("weight_syncs", [])):
                break
            check(all(pr.poll() is None for pr, _, _ in procs),
                  f"a rollout server exited: {_tail(log8)}")
            check(time.monotonic() - t0 < 120, "the int8 push never landed")
            time.sleep(0.1)
    c = iface.counters()
    check(c["transfer/push_failures"] == 0 and c["transfer/verify_failures"] == 0,
          f"the push into the int8 server failed: {json.dumps(c)}")
    info8 = post(port8, "/get_server_info", None)
    sy = {s_["version"]: s_ for s_ in info8.get("weight_syncs", [])}.get(v, {})
    rd = {r_["version"]: r_ for r_ in iface.sender.round_log}.get(v, {})
    pl = {p_["version"]: p_ for p_ in iface.push_log}.get(v, {})
    check(bool(sy), f"the int8 server logged no install of v{v}")
    rng = np.random.default_rng(3)
    prompt = rng.integers(1, mcfg.vocab_size, 40).tolist()
    served = greedy_run(port8, prompt, DISAGG_GREEDY, "d8greedy")
    qparams = quant.quantize_params(params)
    eng = CBEngine(mcfg, qparams, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
                   max_slots=64, page_size=64, max_seq_len=512,
                   num_pages=DISAGG_INT8_PAGES, steps_per_dispatch=8,
                   prompt_buckets=(64, 128), seed=0, device=dev)
    try:
        local = eng.generate([prompt], SamplingParams(
            temperature=0.0, max_new_tokens=DISAGG_GREEDY))[0]
    finally:
        eng.stop()
    del eng
    params32 = dequantized_f32(qparams)
    del qparams
    gaps = top2_gaps(params32, mcfg, prompt, local["token_ids"], dev)
    ok, first, tie, gap = agrees_until_tie(served["tokens"],
                                           list(local["token_ids"]), gaps)
    check(ok, f"disagg int8: served tokens part from the in-process int8 "
          f"engine's at {first} (first near-tie {tie}, f32 gap {gap:.4f})")
    err, _ = dense_f32_gate(params32, mcfg, prompt, served["tokens"],
                            served["logprobs"], dev)
    del params32
    check(err <= DENSE_LOGP_TOL, f"disagg int8: {err:.4f} nats from the dense "
          "f32 forward on the dequantized weights")
    return dict(version=v, up_s=up_s, bytes=sy.get("bytes", 0),
                pack_s=pl.get("pack_s", float("nan")),
                wire_s=rd.get("push_s", float("nan")),
                install_s=sy.get("install_s", float("nan")),
                swap_s=sy.get("swap_s", float("nan")),
                raise_s=sy.get("t_wall", float("nan")) - pl.get("t_wall", float("nan")),
                bitwise=served["tokens"] == list(local["token_ids"]),
                logprobs_bitwise=served["logprobs"] == list(local["logprobs"]),
                first=first, tie=tie, gap=gap, dense_err=err,
                peak=info8.get("peak_memory_bytes", 0) / 1e9)


def disagg_lines(out: dict, smi: str) -> list[str]:
    lines = []
    for p_ in out["pushes"]:
        gb = p_["bytes"] / 1e9
        lines.append(
            f"disagg ({smi}, this run): push v{p_['version']}: {gb:.3f} GB; pack "
            f"(device to host) {p_['pack_s']:.3f} s ({gb / p_['pack_s']:.2f} GB/s), "
            f"wire (ready to verified, trailing the pack) {p_['wire_s']:.3f} s "
            f"({gb / p_['wire_s']:.2f} GB/s), install (host to device) "
            f"{p_['install_s']:.3f} s ({gb / p_['install_s']:.2f} GB/s), swap "
            f"{p_['swap_s']:.3f} s; version raised {p_['raise_s']:.3f} s after "
            f"the trainer bumped it")
    for i, rec in enumerate(out["history"], 1):
        lines.append(
            f"disagg ({smi}, this run): step {i}: wall {rec['perf/step_time_s']:.2f} s "
            f"(colocated train phase {out['colocated'][i - 1]:.2f} s); "
            + ", ".join(f"{k_} {rec.get('timing_s/' + k_, 0.0):.2f}" for k_ in (
                "reward", "old_log_prob", "ref_log_prob", "adv", "update_actor",
                "update_weight"))
            + f"; bubble {rec['perf/trainer_bubble_s']:.2f} s; max_local_gen_s "
            f"{rec['training/max_local_gen_s']:.1f}; pg_loss "
            f"{rec['actor/pg_loss']:.5f}, grad_norm {rec['actor/grad_norm']:.4f}")
        g_ = out["gen"][i - 1]
        co = out["colocated_gen"][i - 1]
        lines.append(
            f"disagg ({smi}, this run): step {i}: generation on the server: "
            f"stream to its last chunk {g_['stream_s']:.3f} s; from its start, the "
            f"version raised at {g_.get('raised_s', float('nan')):.3f} s, first "
            f"request admitted at {g_.get('admit_s', float('nan')):.3f} s, first "
            f"token at {g_.get('first_tok_s', float('nan')):.3f} s, the most "
            f"running ({g_.get('peak_running', 0)}) from "
            f"{g_.get('full_s', float('nan')):.3f} s, last token at "
            f"{g_.get('last_tok_s', float('nan')):.3f} s, the last chunk in the "
            f"trainer {g_.get('tail_s', float('nan')):.3f} s later; {g_['tokens']} tokens, "
            f"{g_.get('tok_s', float('nan')):.1f} tok/s between first and last "
            f"token; {g_.get('dispatches', 0)} decode dispatches; "
            f"{g_.get('captures', 0)} graph captures "
            f"({g_.get('capture_s', 0.0):.3f} s) (colocated train phase: gen "
            f"{co[0]:.3f} s, rollout gauge {co[1]:.1f} tok/s; its engine's "
            f"decode dispatches over both steps {out['colocated_dispatches']})")
        s0, s1, _v = out["streams"][i - 1]
        polled = [(o, d) for t_, o, d in out["feed"] if s0 <= t_ <= s1]
        lines.append(
            f"disagg ({smi}, this run): step {i}: the server's occupancy / "
            f"device_frac polled during its stream: "
            + (f"first {polled[0]}, last {polled[-1]}, max occupancy "
               f"{max(o for o, _ in polled):.4f}, max device_frac "
               f"{max(d for _, d in polled):.4f}" if polled else "none")
            + f"; the record's engine/occupancy {rec['engine/occupancy']:.4f}, "
            f"engine/device_frac {rec['engine/device_frac']:.4f}; the "
            f"balancer's observation {json.dumps(out['balance']['seen'][i - 1])}")
    tr = out["balance"]["trends"]
    lines.append(
        f"disagg ({smi}, this run): balance.trends() after the fit: "
        f"occupancy_slope {tr.get('occupancy_slope')}, device_frac_slope "
        f"{tr.get('device_frac_slope')}, valid {tr.get('balance_trends_valid')} "
        f"(the estimator zeroes every slope below three steps)")
    g = out["greedy"]
    lines.append(
        f"disagg ({smi}, this run): fit wall {out['fit_wall']:.1f} s; greedy "
        f"through the manager against the in-process engine: tokens "
        f"{'bitwise' if g['bitwise'] else 'part at %d (near-tie %d, f32 gap %.4f)' % (g['first'], g['tie'], g['gap'])}, "
        f"logprobs {'bitwise' if g['logprobs_bitwise'] else 'not bitwise'}; "
        f"{g['dense_err']:.4f} nats from dense f32; launches: server "
        + json.dumps(out["server_launches"]) + ", trainer "
        + json.dumps({k_: out["trainer_launches"][k_] for k_ in TRAIN_KERNELS})
        + f"; peak memory trainer {out['trainer_peak']:.2f} GB, server "
        f"{out['server_peak']:.2f} GB; server up in {out['server_up_s']:.1f} s, "
        f"manager built and up in {out['manager_s']:.1f} s")
    q = out["int8"]
    gb = q["bytes"] / 1e9
    lines.append(
        f"disagg ({smi}, this run): int8 server (up in {q['up_s']:.1f} s) took "
        f"push v{q['version']} of the bf16 tree: {gb:.3f} GB; pack "
        f"{q['pack_s']:.3f} s, wire {q['wire_s']:.3f} s ({gb / q['wire_s']:.2f} "
        f"GB/s), install {q['install_s']:.3f} s, swap with re-quantization "
        f"{q['swap_s']:.3f} s; raised {q['raise_s']:.3f} s after the bump; greedy "
        f"against the in-process int8 engine on quantize_params of the same "
        f"tree: tokens "
        f"{'bitwise' if q['bitwise'] else 'part at %d (near-tie %d, f32 gap %.4f)' % (q['first'], q['tie'], q['gap'])}, "
        f"logprobs {'bitwise' if q['logprobs_bitwise'] else 'not bitwise'}; "
        f"{q['dense_err']:.4f} nats from dense f32 on the dequantized weights; "
        f"int8 server peak {q['peak']:.2f} GB")
    pl = out["planes"]
    lines.append(
        f"disagg ({smi}, this run): the server's /statusz sections "
        f"{pl['sections']}; its loop window device_frac "
        f"{pl['loop_device_frac']}, token attribution {pl['attributed']}; "
        f"/metrics parsed {pl['metrics']} series")
    for i, rec in enumerate(out["history"], 1):
        lines.append(f"disagg ({smi}, this run): step {i} goodput: "
                     f"{goodput_split(rec)}")
    return lines


# the memory phase: a capped engine whose sessions contend for 96 pages
# (0.70 GB of KV at qwen3-1.7b: 28 layers x K and V x 8 kv heads x 64 x 128
# x 2 B = 7,340,032 B a page), a never-spilling one of 1,024 pages
MEM_ENGINE = dict(max_slots=8, page_size=PS, max_seq_len=1024,
                  prompt_buckets=(64, 128, 256, 512), steps_per_dispatch=8,
                  seed=0, kv_cold_after_dispatches=4, kv_spill_host_gb=2.0)
MEM_PAGES = 97
MEM_BIG_PAGES = 1025
MEM_SESSIONS = 16        # two rounds of 8 (the slots), then each resumed
MEM_PROMPT = 512         # 7 full pages published a session (the 8th holds
MEM_NEW = 64             # the suffix's last token), 9 pages while decoding
MEM_MIN_PAGES = 32       # at least this many pages spilled, and restored
MEM_LP_TOL = 5e-4        # the reference's own bound, nats
MEM_GROUP_PREFIX = 448   # the grouped mix: 7 spilled pages + 16 new tokens
ACCOUNTING_BUDGET = 0.15  # accounting + spill_sweep over the loop's busy wall
MEM_AB_RUNS = 5          # planes on against off, in turns


def engine_quiet(eng, timeout: float = 120.0) -> None:
    """Wait until the engine is quiescent (no active slot, nothing
    pending, queued or in flight), read under its dispatch lock."""
    deadline = time.monotonic() + timeout
    while True:
        with eng._pool_lock:
            quiet = (not eng._active.any() and not eng._pending
                     and eng._queue.empty() and not eng._chunk_jobs
                     and eng._outstanding() == 0)
        if quiet:
            return
        check(time.monotonic() < deadline, "the engine did not go quiet")
        eng._idle.wait(0.05)


def engine_requests(eng, reqs: list[dict], hold: bool = False) -> list[dict]:
    """Submit ``reqs`` (rid, input_ids, sampling, optional group hints) at
    once to a started engine and read every stream: tokens, logprobs,
    finish reason and each line's arrival time. ``hold`` keeps the engine
    from admitting until every request is queued (the same waves on every
    run)."""
    if hold:
        eng._paused.set()
    qs = [eng.submit(r["rid"], r["input_ids"], r["sampling"],
                     group_id=r.get("group_id", ""),
                     group_size=r.get("group_size", 0)) for r in reqs]
    if hold:
        eng._paused.clear()
    outs, threads = timed_streams(qs)
    for t in threads:
        t.join(timeout=600)
        check(not t.is_alive(), "an engine stream did not finish")
    res = []
    for r, o in zip(reqs, outs):
        res.append(dict(rid=r["rid"], t=[ts for ts, _ in o],
                        tokens=[x for _, it in o for x in it["token_ids"]],
                        logprobs=[x for _, it in o for x in it["logprobs"]],
                        reason=o[-1][1]["finish_reason"] if o else "none"))
        check(res[-1]["reason"] == "length",
              f"{r['rid']}: finish {res[-1]['reason']!r}")
    return res


def memory_sessions(eng, prompts: list, sp, between=None,
                    hold: bool = False) -> list[dict]:
    """The sessions: two rounds of 8 fresh prompts (each round one wave,
    waited for), then each session resumed alone with its own prompt, so
    that its prefix hit lands on pages the pressure spilled; ``between()``
    runs once the first pass is quiet; ``hold`` as ``engine_requests``."""
    out = []
    for r in range(0, len(prompts), 8):
        out += engine_requests(eng, [
            {"rid": f"s{i}", "input_ids": prompts[i], "sampling": sp}
            for i in range(r, min(r + 8, len(prompts)))], hold)
    engine_quiet(eng)
    if between is not None:
        between()
    for i, p in enumerate(prompts):
        out += engine_requests(eng, [{"rid": f"r{i}", "input_ids": p,
                                      "sampling": sp}], hold)
    engine_quiet(eng)
    return out


def streams_gap(a: list[dict], b: list[dict]) -> tuple[bool, bool, float, list]:
    """(tokens equal everywhere, logprobs bitwise everywhere, the largest
    |logprob diff| where the tokens agree, the rids whose tokens part)."""
    toks = all(x["tokens"] == y["tokens"] for x, y in zip(a, b))
    bitwise = toks and all(x["logprobs"] == y["logprobs"] for x, y in zip(a, b))
    gap, parted = 0.0, []
    for x, y in zip(a, b):
        n = min(len(x["tokens"]), len(y["tokens"]))
        first = next((j for j in range(n) if x["tokens"][j] != y["tokens"][j]), n)
        if first < n:
            parted.append((x["rid"], first))
        if first:
            gap = max(gap, float(np.abs(np.asarray(x["logprobs"][:first])
                                        - np.asarray(y["logprobs"][:first])).max()))
    return toks, bitwise, gap, parted


def spilled_entries(eng) -> list:
    return [e for e in eng.prefix_cache._map.values() if e.spilled]


def timed_spill(eng, dev) -> tuple[list, float]:
    """Spill every unreferenced published page at once, the device idle
    before (so the copy lane is empty): (the entries, seconds from queueing
    the gather to the copies landing on the host)."""
    before = {id(e) for e in spilled_entries(eng)}
    torch.cuda.synchronize(dev)
    with eng._pool_lock:
        t0 = time.monotonic()
        eng._spill_pages(eng.num_pages, cold_only=False)
        eng.kvspill.synchronize()
        dt = time.monotonic() - t0
    return [e for e in spilled_entries(eng) if id(e) not in before], dt


def timed_restore(eng, dev, entries: list) -> float:
    """Restore ``entries`` at once: seconds from the host buffers to the
    pages written into the pools."""
    torch.cuda.synchronize(dev)
    with eng._pool_lock:
        t0 = time.monotonic()
        check(eng._restore_entries(entries), "the restore found no pages")
        torch.cuda.synchronize(dev)
        return time.monotonic() - t0


def memory_phase(dev) -> dict:
    """The engine's memory plane at ``qwen3-1.7b`` full width and depth
    (bf16, weights from seed 0) under a capped pool: 16 greedy sessions of
    512 random tokens and 64 new ones on 96 pages (two rounds of 8, then
    each resumed alone) spill published pages to pinned host buffers and
    restore them on their prefix hit. Gates: at least MEM_MIN_PAGES pages
    spilled and restored; the streams against a never-spilling engine of
    1,024 pages on the same requests, bitwise (else the break named, the
    floor equal tokens and logprobs within MEM_LP_TOL); the capped run with
    ``kv_spill=False`` equal tokens, logprobs within MEM_LP_TOL; at
    quiescence the ledger's attributed_frac 1.0 (its roles the allocator's
    free list plus the cache's entries, spilled ones included), the flight
    deck's 1.0, the loop profiler's at most 1 + 1e-6, accounting plus
    spill sweep under ACCOUNTING_BUDGET of the loop's busy wall; the pools
    at their addresses and no decode graph captured again after the
    restores; a grouped mix (2 GRPO groups of 8, greedy, on two spilled
    7-page prefixes plus 16 tokens) against the never-spilling engine,
    tokens equal (or parting at a logged near-tie) and logprobs within
    MEM_LP_TOL; K1 fused, K2 and K3 launched, counted from zero. Readings:
    spill (gather plus device-to-host) and restore (host-to-device plus
    ``index_copy_``) GB/s, peak pinned bytes, kv_spilled_frac,
    kv_restore_rate, HBM use and headroom, the profiler's fractions beside
    torch.profiler's busy share of the grouped mix. Then the same sessions
    on tp=2 shards, one spill lane each (``memory_tp_spill``), the capped
    run with spill off and ``memory_ab``."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = decoder.init_params(gen, cfg)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg.vocab_size, MEM_PROMPT).tolist()
               for _ in range(MEM_SESSIONS)]
    greedy = SamplingParams(temperature=0.0, max_new_tokens=MEM_NEW)
    tails = [rng.integers(1, cfg.vocab_size, 16).tolist() for _ in range(2)]
    groups = [{"rid": f"g{g}-{i}",
               "input_ids": prompts[g][:MEM_GROUP_PREFIX] + tails[g],
               "sampling": greedy, "group_id": f"mgrp{g}", "group_size": 8}
              for g in range(2) for i in range(8)]

    def make(num_pages: int, **kw):
        return CBEngine(cfg, params, pad_token_id=0,
                        kv_cache_dtype=torch.bfloat16, num_pages=num_pages,
                        device=dev, **{**MEM_ENGINE, **kw}).start()

    out: dict = {}
    capped = make(MEM_PAGES)
    try:
        kp, vp = capped._pools
        ptrs = [t.data_ptr() for t in kp + vp]
        page_bytes = sum(t[:, 0].numel() * t.element_size() for t in kp + vp)
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        first: dict = {}

        def after_first_pass():
            first.update(captures=capped.graph_captures,
                         replays=capped.graph_replays,
                         spilled=capped.kvledger.pages_spilled)

        got = memory_sessions(capped, prompts, greedy, after_first_pass)
        out["sessions_s"] = time.monotonic() - t0
        torch.cuda.synchronize(dev)  # every copy landed, so timed
        info = capped.kv_memory_info()
        snap = capped.kv_memory_snapshot()
        host = snap["spill"]["host"]
        out["traffic"] = {k_: host[k_] for k_ in (
            "bytes_spilled", "d2h_s", "bytes_restored", "h2d_s",
            "copy_batches", "lane_full")}
        check(host["d2h_s"] > 0 and host["h2d_s"] > 0,
              f"memory: the sessions' copies were not timed: {out['traffic']}")
        out["pages"] = dict(spilled=info["memory/pages_spilled"],
                            spilled_first=first["spilled"],
                            restored=info["memory/pages_restored"],
                            drops=info["memory/spill_drops"],
                            evicted=capped.prefix_cache.evictions["capacity"],
                            spilled_frac=info["kv_spilled_frac"],
                            restore_rate=info["kv_restore_rate"],
                            hbm_used=info["hbm_used_gb"],
                            hbm_headroom=info["hbm_headroom_gb"],
                            behind=snap["spill"]["host"]["restores_behind_copy"])
        log(f"memory: sessions on {MEM_PAGES - 1} pages: "
            + json.dumps(out["pages"]) + f"; reconcile "
            + json.dumps(snap["reconcile"]) + f"; {out['sessions_s']:.1f} s")
        check(info["memory/pages_spilled"] >= MEM_MIN_PAGES
              and info["memory/pages_restored"] >= MEM_MIN_PAGES,
              f"memory: {info['memory/pages_spilled']} pages spilled and "
              f"{info['memory/pages_restored']} restored, under {MEM_MIN_PAGES}")
        rec = snap["reconcile"]
        check(rec["attributed_frac"] == 1.0
              and rec["ledger_free"] == rec["pool_free"] == capped.allocator.free_count
              and rec["ledger_cache"] == rec["cache_pages"]
              == capped.prefix_cache.num_entries,
              f"memory: the ledger does not reconcile: {json.dumps(rec)}")
        check(snap["roles"]["spilled"] == len(spilled_entries(capped))
              == capped.kvspill.resident_pages,
              "memory: spilled pages disagree between ledger, cache and host")
        check(capped.deck.attributed_frac() == 1.0,
              f"memory: the flight deck's tokens do not reconcile "
              f"({capped.deck.attributed_frac()})")
        check(capped.graph_captures == first["captures"]
              and capped.graph_replays > first["replays"],
              "memory: a decode graph was captured again after the restores")
        check([t.data_ptr() for t in kp + vp] == ptrs,
              "memory: the pools moved")
        prof = capped.loop_profile_snapshot()
        busy = prof["wall_s"] - prof["phase_s"]["idle"]
        acct = prof["phase_s"]["accounting"] + prof["phase_s"]["spill_sweep"]
        out["loop"] = dict(attributed=prof["attributed_frac"],
                           acct_frac=acct / busy, phase_s=prof["phase_s"])
        check(prof["attributed_frac"] <= 1.0 + 1e-6,
              f"memory: loop attribution {prof['attributed_frac']} > 1")
        check(acct / busy < ACCOUNTING_BUDGET,
              f"memory: accounting {acct:.3f} s of {busy:.3f} s busy")

        # the same requests on an engine that never spills
        big = make(MEM_BIG_PAGES)
        try:
            want = memory_sessions(big, prompts, greedy)
            check(big.kvledger.pages_spilled == 0, "the big pool spilled")
            toks, bitwise, gap, parted = streams_gap(got, want)
            out["big"] = dict(tokens=toks, bitwise=bitwise, gap=gap,
                              parted=parted)
            log(f"memory: capped spilling against never spilling: tokens "
                f"{'equal' if toks else 'part ' + str(parted)}, logprobs "
                f"{'bitwise' if bitwise else 'max |diff| %.3e' % gap}")
            check(toks and gap <= MEM_LP_TOL,
                  f"memory: capped against never spilling: {out['big']}")

            # spill and restore rates, then the grouped mix on two spilled
            # prefixes against the same mix on the big engine
            ents, dt_s = timed_spill(capped, dev)
            n_s = n_r = len(ents)
            dt_r = timed_restore(capped, dev, ents)
            ents2, dt_s2 = timed_spill(capped, dev)
            n_s2 = len(ents2)
            out["rates"] = dict(
                spill=(n_s, n_s * page_bytes / dt_s / 1e9),
                restore=(n_r, n_r * page_bytes / dt_r / 1e9),
                spill2=(n_s2, n_s2 * page_bytes / dt_s2 / 1e9),
                pinned=capped.kvspill.stats()["pinned_bytes"])
            check(n_s > 0 and n_s2 == n_s,
                  f"memory: the timed spills moved {n_s} and {n_s2} pages")
            launches0 = dict(cuda_build.LAUNCHES)
            res: dict = {}
            prof = capped.profiler

            def grouped():
                res["t0"] = time.monotonic()
                res["p0"] = (dict(prof.totals), prof.wall_s)
                res["out"] = engine_requests(capped, groups)
                engine_quiet(capped)
                res["p1"] = (dict(prof.totals), prof.wall_s)

            busy_ms = device_profile(grouped, 1)["device_ms"]
            wall_ms = (max(o["t"][-1] for o in res["out"]) - res["t0"]) * 1e3
            # the loop profiler over the same mix: its phases' growth over
            # the growth of the loop's wall
            (t0_, w0_), (t1_, w1_) = res["p0"], res["p1"]
            d_wall = w1_ - w0_
            d = {p_: t1_[p_] - t0_[p_] for p_ in t0_}
            mix_fracs = dict(
                device_frac=(d["prefill_dispatch"] + d["decode_dispatch_device"]
                             + d["sample_fetch"]) / d_wall,
                accounting_frac=(d["accounting"] + d["spill_sweep"]) / d_wall,
                idle_frac=d["idle"] / d_wall, restore_s=d["restore"])
            launched = {k_: cuda_build.LAUNCHES[k_] - launches0[k_]
                        for k_ in SERVE_KERNELS}
            check(launched["grouped_paged_attention"] > 0,
                  f"memory: the grouped mix did not take K3: {launched}")
            ref = engine_requests(big, groups)
            toks, bitwise, gap, parted = streams_gap(res["out"], ref)
            ties = []
            if not toks:
                p32 = f32_copy(params)
                for rid, first in parted:
                    o = next(x for x in ref if x["rid"] == rid)
                    prompt = next(g["input_ids"] for g in groups if g["rid"] == rid)
                    gaps = top2_gaps(p32, cfg, prompt, o["tokens"], dev)
                    mine = next(x for x in res["out"] if x["rid"] == rid)
                    ok, f_, tie, g_ = agrees_until_tie(mine["tokens"], o["tokens"], gaps)
                    ties.append((rid, f_, tie, round(g_, 4)))
                    check(ok, f"memory: grouped {rid} parts at {f_} before a "
                          f"near-tie ({tie}, f32 gap {g_:.4f})")
                del p32
            out["grouped"] = dict(tokens=toks, bitwise=bitwise, gap=gap,
                                  ties=ties, busy=busy_ms / wall_ms,
                                  launched=launched, fracs=mix_fracs)
            check(gap <= MEM_LP_TOL, f"memory: grouped mix {out['grouped']}")
        finally:
            big.stop()
        del big
        out["launches"] = dict(cuda_build.LAUNCHES)
        for name in SERVE_KERNELS:
            check(out["launches"][name] > 0,
                  f"{name} was not launched in the memory phase")
        out["info"] = capped.kv_memory_info()
        out["deck"] = capped.deck.attributed_frac()
    finally:
        capped.stop()
    del capped
    gc.collect()
    torch.cuda.empty_cache()
    out["tp"] = memory_tp_spill(dev, cfg, params, prompts, greedy)

    # the capped run with the spill tier off: evicted prefixes prefill again
    off = make(MEM_PAGES, kv_spill=False)
    try:
        got_off = memory_sessions(off, prompts, greedy)
        check(off.kvspill is None and off.kvledger.pages_spilled == 0,
              "the spill-off engine spilled")
        evicted = off.prefix_cache.evictions["capacity"]
    finally:
        off.stop()
    del off
    toks, bitwise, gap, parted = streams_gap(got, got_off)
    out["off"] = dict(tokens=toks, bitwise=bitwise, gap=gap, parted=parted,
                      evicted=evicted)
    log(f"memory: spill on against off: tokens "
        f"{'equal' if toks else 'part ' + str(parted)}, logprobs "
        f"{'bitwise' if bitwise else 'max |diff| %.3e' % gap}; the off run "
        f"evicted {evicted} pages")
    check(toks and gap <= MEM_LP_TOL, f"memory: spill on against off: {out['off']}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["ab"] = memory_ab(dev)
    return out


def lane_rates(before: list, after: list, nbytes: str, secs: str) -> list:
    """Each spill lane's GB/s over one timed batch: its bytes over its
    copies' device seconds (events on the card)."""
    return [(a[nbytes] - b_[nbytes]) / max(a[secs] - b_[secs], 1e-12) / 1e9
            for b_, a in zip(before, after)]


def memory_tp_spill(dev, cfg, params, prompts: list, sp) -> dict:
    """The memory phase's sessions on a ``tp=2`` engine of the same
    weights, both shards on the card, one spill lane a shard: 16 greedy
    sessions of 512 + 64 tokens on 96 pages (two rounds of 8, then each
    resumed alone), then on a ``tp=2`` engine of 1,024 pages that never
    spills, both admitting each round held (the same waves). Gates: at
    least MEM_MIN_PAGES pages spilled and restored, through both lanes;
    the streams bitwise the never-spilling engine's; the ledger's
    attributed_frac 1.0 at quiescence, its spilled pages the host tier's;
    the pools at their addresses and no decode graph captured again after
    the first pass; the fused prologue and K2 launched on both shards (a
    multiple of ``TP x layers``), the unfused K1 not. Readings: a timed
    spill and restore of every unreferenced published page, GB/s summed
    (a page's bytes over both shards, by the host's clock) and each lane's
    (its bytes over its copies' device seconds), the peak pinned bytes."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    t_phase = time.monotonic()

    def make(num_pages: int):
        return CBEngine(cfg, params, pad_token_id=0,
                        kv_cache_dtype=torch.bfloat16, num_pages=num_pages,
                        device=dev, tp=TP, **MEM_ENGINE).start()

    out: dict = {}
    capped = make(MEM_PAGES)
    try:
        pools = [t for kp, vp in capped._pools for t in kp + vp]
        ptrs = [t.data_ptr() for t in pools]
        page_bytes = sum(t[:, 0].numel() * t.element_size() for t in pools)
        first: dict = {}

        def after_first_pass():
            first.update(captures=capped.graph_captures,
                         replays=capped.graph_replays)

        cuda_build.reset_launch_counts()
        got = memory_sessions(capped, prompts, sp, after_first_pass, hold=True)
        out["launches"] = dict(cuda_build.LAUNCHES)
        torch.cuda.synchronize(dev)
        info = capped.kv_memory_info()
        snap = capped.kv_memory_snapshot()
        lanes = snap["spill"]["host"]["lanes"]
        out["pages"] = dict(spilled=info["memory/pages_spilled"],
                            restored=info["memory/pages_restored"],
                            lanes=[(ln["bytes_spilled"], ln["bytes_restored"])
                                   for ln in lanes])
        check(info["memory/pages_spilled"] >= MEM_MIN_PAGES
              and info["memory/pages_restored"] >= MEM_MIN_PAGES,
              f"tp spill: {info['memory/pages_spilled']} pages spilled and "
              f"{info['memory/pages_restored']} restored, under {MEM_MIN_PAGES}")
        check(len(lanes) == TP and all(ln["bytes_spilled"] > 0
                                       and ln["bytes_restored"] > 0
                                       for ln in lanes),
              f"tp spill: not every lane spilled and restored: {out['pages']}")
        rec = snap["reconcile"]
        check(rec["attributed_frac"] == 1.0
              and rec["ledger_free"] == rec["pool_free"]
              == capped.allocator.free_count,
              f"tp spill: the ledger does not reconcile: {json.dumps(rec)}")
        check(snap["roles"]["spilled"] == len(spilled_entries(capped))
              == capped.kvspill.resident_pages,
              "tp spill: spilled pages disagree between ledger, cache and host")
        check(capped.graph_captures == first["captures"]
              and capped.graph_replays > first["replays"],
              "tp spill: a decode graph was captured again after the restores")
        check([t.data_ptr() for t in pools] == ptrs, "tp spill: the pools moved")
        n_l = cfg.num_layers
        for name in ("paged_kv_write_fused", "paged_attention"):
            check(out["launches"][name] > 0
                  and out["launches"][name] % (TP * n_l) == 0,
                  f"tp spill: {name} launched {out['launches'][name]} times "
                  f"(want a positive multiple of {TP} x {n_l})")
        check(out["launches"]["paged_kv_write"] == 0,
              "tp spill: the unfused K/V write ran")

        # spill, restore, spill again (as the one-shard readings: the first
        # spill's wall carries the gather block's first allocation)
        lanes0 = capped.kvspill.stats()["lanes"]
        ents, dt_s = timed_spill(capped, dev)
        lanes1 = capped.kvspill.stats()["lanes"]
        dt_r = timed_restore(capped, dev, ents)
        lanes2 = capped.kvspill.stats()["lanes"]
        ents2, dt_s2 = timed_spill(capped, dev)
        lanes3 = capped.kvspill.stats()["lanes"]
        n = len(ents)
        check(n > 0 and len(ents2) == n,
              f"tp spill: the timed spills moved {n} and {len(ents2)} pages")
        out["rates"] = dict(
            pages=n, spill=n * page_bytes / dt_s / 1e9,
            restore=n * page_bytes / dt_r / 1e9,
            spill2=n * page_bytes / dt_s2 / 1e9,
            spill_lanes=lane_rates(lanes0, lanes1, "bytes_spilled", "d2h_s"),
            restore_lanes=lane_rates(lanes1, lanes2, "bytes_restored", "h2d_s"),
            spill2_lanes=lane_rates(lanes2, lanes3, "bytes_spilled", "d2h_s"),
            pinned=capped.kvspill.stats()["pinned_bytes"])

        big = make(MEM_BIG_PAGES)
        try:
            want = memory_sessions(big, prompts, sp, hold=True)
            check(big.kvledger.pages_spilled == 0, "tp spill: the big pool spilled")
        finally:
            big.stop()
        del big
        toks, bitwise, gap, parted = streams_gap(got, want)
        out["big"] = dict(tokens=toks, bitwise=bitwise, gap=gap, parted=parted)
        check(bitwise, f"tp spill: capped against never spilling: {out['big']}")
    finally:
        capped.stop()
    del capped
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.monotonic() - t_phase
    return out


def memory_tp_lines(t: dict, smi: str) -> list[str]:
    r, pg = t["rates"], t["pages"]
    return [
        f"memory tp spill (tp {TP}, both shards on the one card, one lane a "
        f"shard; {smi}, this run): {pg['spilled']:.0f} pages spilled, "
        f"{pg['restored']:.0f} restored over {MEM_PAGES - 1} pages; lanes' "
        f"(bytes spilled, restored) {pg['lanes']}; against never spilling "
        + json.dumps(t["big"]) + "; launches "
        + json.dumps({k_: t["launches"][k_] for k_ in SERVE_KERNELS}),
        f"memory tp spill ({smi}, this run): spill of {r['pages']} pages "
        f"(gathers on the compute stream + each lane's device-to-host) "
        f"{r['spill']:.2f} GB/s summed by the host's clock, lanes "
        + ", ".join(f"{x:.2f}" for x in r["spill_lanes"])
        + f" GB/s by their copies' device seconds; again {r['spill2']:.2f} "
        f"GB/s summed, lanes "
        + ", ".join(f"{x:.2f}" for x in r["spill2_lanes"])
        + f"; restore {r['restore']:.2f} GB/s summed, lanes "
        + ", ".join(f"{x:.2f}" for x in r["restore_lanes"])
        + f" GB/s; peak pinned {r['pinned'] / 1e9:.3f} GB; "
        f"{t['seconds']:.1f} s",
    ]


def step_host_timer(eng) -> dict:
    """Time the engine's decode passes on the instance: ``step_s`` sums the
    wall of every ``_step_once``, ``drain_s`` that of the output drains
    inside them (where the loop waits on the device). Their difference is
    the host's whole cost of the passes: the abort scan, the launch, the
    kernel-read accounting, the flight deck, the ledger's touch and tier
    sweep, the spill sweep and the profiler's phases."""
    acc = {"step_s": 0.0, "drain_s": 0.0}
    step, drain = eng._step_once, eng._drain_emit_q
    inside = threading.local()

    def timed_drain(*a, **kw):
        if not getattr(inside, "step", False):
            return drain(*a, **kw)
        t0 = time.perf_counter()
        try:
            return drain(*a, **kw)
        finally:
            acc["drain_s"] += time.perf_counter() - t0

    def timed_step():
        inside.step = True
        t0 = time.perf_counter()
        try:
            step()
        finally:
            inside.step = False
            acc["step_s"] += time.perf_counter() - t0

    eng._step_once, eng._drain_emit_q = timed_step, timed_drain
    return acc


def sweep_peak(eng, dev, vocab: int) -> dict:
    """Device memory around one full spill sweep at ``eng``'s pool: greedy
    one-token requests publish pages until the cache holds the sweep's
    target (the watermarks' gap times the pool), then one spill of that
    many pages, the device idle before it: the peak allocated above the
    level before, beside the gathered block's bytes."""
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    n = eng.num_pages - 1
    target = int(np.ceil((eng.kv_spill_high_watermark
                          - eng.kv_spill_low_watermark) * n))
    per = (MEM_PROMPT - 1) // PS  # full pages a prompt publishes
    rng = np.random.default_rng(11)
    one = SamplingParams(temperature=0.0, max_new_tokens=1)
    engine_requests(eng, [{"rid": f"fill{i}", "sampling": one,
                           "input_ids": rng.integers(1, vocab, MEM_PROMPT).tolist()}
                          for i in range(-(-target // per))])
    engine_quiet(eng)
    kp, vp = eng._pools
    page_bytes = sum(t[:, 0].numel() * t.element_size() for t in kp + vp)
    torch.cuda.synchronize(dev)
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    with eng._pool_lock:
        t0 = time.monotonic()
        got = eng._spill_pages(target, cold_only=False)
        torch.cuda.synchronize(dev)
        dt = time.monotonic() - t0
    peak = torch.cuda.max_memory_allocated(dev) - base
    check(got == target, f"the sweep at {n} pages spilled {got} of {target}")
    return dict(pages=got, pool=n, block=got * page_bytes, peak=peak, s=dt)


def memory_ab(dev) -> dict:
    """The serve phase's 18-stream GRPO mix on the serve phase's engine
    (64 slots, 2,048 pages, bf16, seed 0) with every plane on (the
    defaults) against ``kv_ledger=False, loop_profile=False``, in turns
    (on, off, off, on, ...), MEM_AB_RUNS each after one warm run each: the
    median and range of decode tok/s, of the host ms per decode dispatch
    in the launch (``decode_host_s``) and in the whole decode pass less
    its drains (``step_host_timer``), and the planes-on engine's profiler
    ms of accounting and spill sweep per dispatch. Then ``sweep_peak`` on
    the planes-on engine."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    cfg = decoder.get_config(MODEL, dtype=torch.bfloat16)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    params = decoder.init_params(gen, cfg)
    bodies, _, _ = serving_mix(cfg.vocab_size)
    reqs = [{"rid": b["rid"], "input_ids": b["input_ids"],
             "sampling": SamplingParams(**b["sampling_params"]),
             "group_id": b.get("group_id", ""),
             "group_size": b.get("group_size", 0)} for b in bodies]
    engines, timers = {}, {}
    for name, kw in (("on", {}), ("off", dict(kv_ledger=False,
                                             loop_profile=False))):
        engines[name] = CBEngine(
            cfg, params, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
            max_slots=64, page_size=PS, max_seq_len=4096, num_pages=2048,
            steps_per_dispatch=8, seed=0, device=dev, **kw)
        timers[name] = step_host_timer(engines[name])
        engines[name].start()
    runs: dict = {"on": [], "off": []}
    try:
        order = ["on", "off"] + ["on", "off", "off", "on"] * (MEM_AB_RUNS // 2)
        order += ["on", "off"][:MEM_AB_RUNS % 2 * 2]
        for i, name in enumerate(order):
            eng, tm = engines[name], timers[name]
            eng.flush_prefix_cache()
            d0, h0 = eng.decode_dispatches, eng.decode_host_s
            s0 = tm["step_s"] - tm["drain_s"]
            prof = eng.profiler
            a0 = (prof.totals["accounting"] + prof.totals["spill_sweep"]
                  if prof is not None else 0.0)
            outs = engine_requests(eng, [{**r, "rid": f"{r['rid']}-{i}"}
                                         for r in reqs])
            engine_quiet(eng)
            first = min(o["t"][0] for o in outs)
            last = max(o["t"][-1] for o in outs)
            n_tok = sum(len(o["tokens"]) for o in outs) - len(outs)
            n_d = max(eng.decode_dispatches - d0, 1)
            acct = ((prof.totals["accounting"] + prof.totals["spill_sweep"]
                     - a0) / n_d * 1e3 if prof is not None else None)
            if i >= 2:  # the first run of each engine warms (captures)
                runs[name].append((n_tok / (last - first),
                                   (eng.decode_host_s - h0) / n_d * 1e3,
                                   (tm["step_s"] - tm["drain_s"] - s0)
                                   / n_d * 1e3, acct))
        peak = sweep_peak(engines["on"], dev, cfg.vocab_size)
    finally:
        for eng in engines.values():
            eng.stop()
    del engines, params
    gc.collect()
    torch.cuda.empty_cache()
    check(len(runs["on"]) == len(runs["off"]) == MEM_AB_RUNS,
          f"memory A/B: {len(runs['on'])} / {len(runs['off'])} runs")
    out = {k: dict(tok_s=[r[0] for r in v], host_ms=[r[1] for r in v],
                   step_ms=[r[2] for r in v], acct_ms=[r[3] for r in v])
           for k, v in runs.items()}
    out["sweep"] = peak
    return out


def memory_lines(m: dict, smi: str) -> list[str]:
    pg, r = m["pages"], m["rates"]
    g, tr, sw = m["grouped"], m["traffic"], m["ab"]["sweep"]
    lines = [
        f"memory ({smi}, this run): capped engine ({MEM_PAGES - 1} pages): "
        f"{pg['spilled']:.0f} pages spilled ({pg['spilled_first']:.0f} in the "
        f"first pass), {pg['restored']:.0f} restored, {pg['drops']:.0f} dropped, "
        f"{pg['evicted']} evicted; restores behind their copy {pg['behind']}; "
        f"kv_spilled_frac {pg['spilled_frac']}, kv_restore_rate "
        f"{pg['restore_rate']}; hbm_used_gb {pg['hbm_used']:.3f}, "
        f"hbm_headroom_gb {pg['hbm_headroom']:.3f} (the card's free memory); "
        f"the sessions took {m['sessions_s']:.1f} s; the phase's launches "
        + json.dumps({k_: m["launches"][k_] for k_ in SERVE_KERNELS}),
        f"memory ({smi}, this run): spill of {r['spill'][0]} pages (gather on "
        f"the compute stream + device-to-host on the copy stream) "
        f"{r['spill'][1]:.2f} GB/s, again {r['spill2'][1]:.2f} GB/s; restore "
        f"of {r['restore'][0]} pages (host-to-device + index_copy_) "
        f"{r['restore'][1]:.2f} GB/s; peak pinned {r['pinned'] / 1e9:.3f} GB",
        f"memory ({smi}, this run): the sessions' own spills and restores, "
        f"copies timed by events on the card: {tr['copy_batches']} spill "
        f"batches, {tr['bytes_spilled'] / 1e9:.3f} GB device-to-host in "
        f"{tr['d2h_s'] * 1e3:.2f} ms ({tr['bytes_spilled'] / tr['d2h_s'] / 1e9:.2f} "
        f"GB/s, the gather's end to the batch landed); "
        f"{tr['bytes_restored'] / 1e9:.3f} GB host-to-device in "
        f"{tr['h2d_s'] * 1e3:.2f} ms "
        f"({tr['bytes_restored'] / tr['h2d_s'] / 1e9:.2f} GB/s, the copies "
        f"alone); spills refused on a full copy lane {tr['lane_full']}",
        f"memory ({smi}, this run): one full sweep at the A/B engine's "
        f"{sw['pool']} pages: {sw['pages']} pages, block "
        f"{sw['block'] / 1e9:.3f} GB, device memory peak above the level "
        f"before {sw['peak'] / 1e9:.3f} GB ({sw['peak'] / sw['block']:.3f} x "
        f"the block), {sw['s'] * 1e3:.1f} ms to the copies landed",
        f"memory ({smi}, this run): capped against never spilling: "
        + json.dumps(m["big"]) + "; spill on against off: "
        + json.dumps(m["off"]),
        f"memory ({smi}, this run): grouped mix on spilled prefixes against "
        f"never spilling: tokens {'equal' if g['tokens'] else 'part ' + str(g['ties'])}, "
        f"logprobs {'bitwise' if g['bitwise'] else 'max |diff| %.3e' % g['gap']}; "
        f"launches {json.dumps(g['launched'])}; the loop profiler over the "
        f"mix: device_frac {g['fracs']['device_frac']:.3f} (host wall in "
        f"dispatch and fetch over loop wall), accounting_frac "
        f"{g['fracs']['accounting_frac']:.4f}, idle_frac "
        f"{g['fracs']['idle_frac']:.3f}, restore {g['fracs']['restore_s']:.4f} s; "
        f"torch.profiler's device busy share of the mix's wall "
        f"{g['busy']:.3f} (the device's own)",
        f"memory ({smi}, this run): loop attribution "
        f"{m['loop']['attributed']}, accounting + spill_sweep "
        f"{m['loop']['acct_frac']:.4f} of the busy wall; phase seconds "
        + json.dumps(m["loop"]["phase_s"]),
    ]
    for name in ("on", "off"):
        a = m["ab"][name]
        lines.append(
            f"memory A/B ({smi}, this run): planes {name}: decode tok/s median "
            f"{statistics.median(a['tok_s']):.1f} (range "
            f"{min(a['tok_s']):.1f}-{max(a['tok_s']):.1f}), host ms per decode "
            f"dispatch median {statistics.median(a['host_ms']):.3f} (range "
            f"{min(a['host_ms']):.3f}-{max(a['host_ms']):.3f}) in the launch, "
            f"{statistics.median(a['step_ms']):.3f} (range "
            f"{min(a['step_ms']):.3f}-{max(a['step_ms']):.3f}) in the whole "
            f"decode pass less its drains"
            + (f", the profiler's accounting + spill_sweep "
               f"{statistics.median(a['acct_ms']):.4f} (range "
               f"{min(a['acct_ms']):.4f}-{max(a['acct_ms']):.4f})"
               if a["acct_ms"][0] is not None else "")
            + "; runs " + json.dumps([round(x, 1) for x in a["tok_s"]]))
    return lines


# -- the hybrid colocated-local rollout (rollout.colocated_local) ------------

HYBRID_GREEDY = 64
HYBRID_WINDOW_S = 0.05    # the abort stream's local-generation window
HYBRID_ABORT_NEW = 128    # its tokens a request
# the window's stream takes a few seconds (PERF.md); a request that stalls on
# the released local engine waits out the manager client's 600 s timeout
HYBRID_WINDOW_MAX_S = 60.0


def hybrid_phase(dev, trained: dict, disagg: dict) -> dict:
    """The hybrid: ``build_trainer`` at the train phase's configuration
    (REMOTE_CUT_LAYERS layers, the server too) with
    ``rollout.mode=disaggregated rollout.colocated_local=true
    obs.trace=true``: an in-process ``CBEngine`` behind a ``RolloutServer``
    on 127.0.0.1 registered as a local, time-sliced instance, beside a
    remote server subprocess as the disagg phase starts one. Gates: finite
    losses and grad norms > 0; no dropped group; the local engine served
    tokens in the fit and both engines in the short window's stream (a
    stream that starts right after a push finds the server still out of
    the routing set until the push has crossed the wire, so the fit's
    split is logged, not gated); the local engine at version 1 + steps with
    the actor's weights bitwise after the last push (in-process swap); its
    KV released after the fit, and a resume/release round trip returning
    at least the pool's bytes; ``training/max_local_gen_s`` > 0 and
    ``critpath/bottleneck`` in every record, with the goodput and health
    keys; a stream with a HYBRID_WINDOW_S window aborts the local engine
    mid-batch and every group still completes at full length; a greedy
    request on the local engine after the fit equal to the same request on
    the server (or parting only at a near-tie) and within DENSE_LOGP_TOL of
    the dense f32 forward; launches counted from zero: the fused prologue,
    K2 and K3 in the trainer's process and in the server's, K4 forward and
    backward in the trainer's. Logs the share served locally, the local
    engine's recapture seconds per generation phase, step walls and bubble
    against the disagg and train phases, ``max_local_gen_s`` and the
    goodput split of each step, and both processes' peaks."""
    from polyrl_tpu_torch import obs
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
    from polyrl_tpu_torch.obs.critical_path import SEGMENTS
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.train import build_trainer

    sup = ManagerSupervisor(bind_addr="127.0.0.1:0", extra_args=[
        "--health-check-interval-s", "0.5", "--stats-poll-interval-s", "0.5"])
    sup.start()
    cleanup: list = [sup.stop]
    procs: list = []
    try:
        cfg = load_config(None, REMOTE_OVERRIDES + [
            "rollout.mode=disaggregated", "rollout.colocated_local=true",
            f"rollout.manager_endpoint={sup.endpoint}",
            # the server's buckets: a prompt of more than a page can reach
            # the local engine (the grouped decode's shared prefix)
            "rollout.prompt_buckets=[64,128]",
            "rollout.transfer_streams=4", "obs.trace=true",
            "obs.trace_buffer=65536", f"device={dev.type}"])
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        remote = trainer.rollout
        local = remote.local_server
        eng = local.engine
        mgr = remote.manager
        port, server_log, _ = spawn_server(
            dev, mgr, sup.endpoint, ["--num-pages", str(DISAGG_PAGES)], procs)
        info0 = post(port, "/get_server_info", None)
        # each release of the local engine's KV: the memory it returned and
        # its capture seconds so far (the recaptures of each phase)
        releases: list[dict] = []
        release = eng.release_memory

        def timed_release(**kw):
            had = eng._pools is not None
            before = torch.cuda.memory_allocated(dev)
            release(**kw)
            releases.append(dict(
                freed=had and eng._pools is None,
                drop_gb=(before - torch.cuda.memory_allocated(dev)) / 1e9,
                capture_s=eng.graph_capture_s, captures=eng.graph_captures))

        eng.release_memory = timed_release
        plane_ms = plane_timers(trainer)
        served0 = eng.total_tokens_served
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t0
        n_steps = cfg.trainer.total_steps
        check(len(history) == n_steps, "the hybrid fit did not finish")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"hybrid step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0, f"hybrid step {i}: zero gradient")
            check(rec.get("training/max_local_gen_s", 0.0) > 0,
                  f"hybrid step {i}: no local-generation budget")
            check("critpath/bottleneck" in rec,
                  f"hybrid step {i}: no critical path with tracing on")
        plane_gates(history, "hybrid")
        check(remote.dropped_groups == 0,
              f"hybrid: {remote.dropped_groups} groups dropped")
        # the fit's split between the engines (the server is out of the
        # routing set while a push crosses the wire, so a stream that starts
        # right after the push may land whole on the local engine)
        local_tokens = eng.total_tokens_served - served0
        info = post(port, "/get_server_info", None)
        server_tokens = info["total_tokens_served"] - info0["total_tokens_served"]
        check(local_tokens > 0, "hybrid: the local engine served nothing in "
              "the fit")
        check(eng.weight_version == 1 + n_steps == remote.weight_version,
              f"hybrid: the local engine at v{eng.weight_version}, the "
              f"rollout at v{remote.weight_version}, not 1 + {n_steps}")
        for (name, a), (_, e) in zip(_leaves(trainer.actor.export_params()),
                                     _leaves(eng.params)):
            check(torch.equal(a.detach(), e),
                  f"hybrid: the local engine's {name} is not the actor's")
        check(eng._pools is None, "hybrid: the local KV pool was not released "
              "after the last generation phase")
        trainer_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        fit_releases = list(releases)

        # the server at the last push's version and back in the routing set
        # before the next stream (the push's wire runs after the fit)
        final = remote.weight_version
        server_ep = f"127.0.0.1:{port}"
        t3 = time.monotonic()
        while not any(i["endpoint"] == server_ep and i["active"]
                      and i.get("weight_version", final) >= final
                      for i in mgr.get_instances_status()["instances"]):
            check(time.monotonic() - t3 < 120, "hybrid: the server never came "
                  f"back at v{final}: {_tail(server_log)}")
            time.sleep(0.1)
        # a window that ends mid-batch: the manager aborts the local engine
        # and its requests continue on the server from their salvaged tokens
        rng = np.random.default_rng(3)
        vocab = trainer.actor.model_cfg.vocab_size
        abort_prompts = [rng.integers(1, vocab, 64).tolist()] * 8 + [
            rng.integers(1, vocab, 64).tolist()] * 8
        local0, salv0 = eng.total_tokens_served, eng.tokens_salvaged
        dropped0 = remote.dropped_groups
        t_win = time.monotonic()
        got = [r for chunk in remote.generate_stream(
            abort_prompts, SamplingParams(temperature=1.0,
                                          max_new_tokens=HYBRID_ABORT_NEW,
                                          stop_token_ids=()),
            group_size=8, min_emit=16, max_local_gen_s=HYBRID_WINDOW_S)
            for _, r in chunk]
        abort_local = eng.total_tokens_served - local0
        check(len(got) == 16 and remote.dropped_groups == dropped0
              and all(len(r.output_token_ids) == HYBRID_ABORT_NEW for r in got),
              f"hybrid: the {HYBRID_WINDOW_S} s window's stream: {len(got)} "
              f"results, lengths {sorted({len(r.output_token_ids) for r in got})}")
        abort_server = (post(port, "/get_server_info", None)["total_tokens_served"]
                        - info["total_tokens_served"])
        check(abort_local > 0 and abort_server > 0,
              f"hybrid: the short window's stream: {abort_local} tokens local, "
              f"{abort_server} on the server (both must serve)")
        window_s = time.monotonic() - t_win
        check(window_s <= HYBRID_WINDOW_MAX_S,
              f"hybrid: the {HYBRID_WINDOW_S} s window's stream took "
              f"{window_s:.1f} s (limit {HYBRID_WINDOW_MAX_S}): a request "
              "stalled on the released local engine")
        # the window's timer releases the KV on its own thread, once the
        # aborted requests have drained: wait for it (bounded)
        t4 = time.monotonic()
        while eng._pools is not None and time.monotonic() - t4 < 60:
            time.sleep(0.05)
        release_wait_s = time.monotonic() - t4
        check(eng._pools is None, "hybrid: the KV was not released after the "
              "window's stream")

        # the KV round trip, measured with nothing else running
        torch.cuda.synchronize()
        eng.resume_memory()
        pool_bytes = sum(t.numel() * t.element_size()
                         for t in eng._pools[0] + eng._pools[1])
        try:
            # greedy on the local engine against the server
            prompt = rng.integers(1, vocab, 40).tolist()
            mine = greedy_run(local.port, prompt, HYBRID_GREEDY, "hgreedy-l")
            theirs = greedy_run(port, prompt, HYBRID_GREEDY, "hgreedy-r")
            # a GRPO group on a prompt longer than a page, on each engine:
            # grouped decode (K3) on both paths (the fit's 64-token prompts
            # fill no shared page)
            group_prompt = rng.integers(1, vocab, 100).tolist()
            for p_, tag in ((local.port, "l"), (port, "r")):
                run_requests(p_, [{
                    "rid": f"hg{tag}{i}", "input_ids": group_prompt,
                    "group_id": f"hgrp{tag}", "group_size": 8,
                    "sampling_params": {"temperature": 1.0,
                                        "max_new_tokens": 64}}
                    for i in range(8)])
        finally:
            # what the engine holds now (the pools, the graphs captured on
            # the requests above) against what it holds after the release
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated(dev)
            release()
        torch.cuda.synchronize()
        drop = held - torch.cuda.memory_allocated(dev)
        check(drop >= pool_bytes, f"hybrid: release returned {drop / 1e9:.3f} "
              f"GB, not the pool's {pool_bytes / 1e9:.3f} GB")
        params32 = f32_copy(trainer.actor.export_params())
        mcfg = trainer.actor.model_cfg
        gaps = top2_gaps(params32, mcfg, prompt, theirs["tokens"], dev)
        ok, first, tie, gap = agrees_until_tie(mine["tokens"], theirs["tokens"],
                                               gaps)
        check(ok, f"hybrid greedy: the local engine parts from the server at "
              f"{first} (first near-tie {tie}, f32 gap {gap:.4f})")
        err = max(dense_f32_gate(params32, mcfg, prompt, o["tokens"],
                                 o["logprobs"], dev)[0] for o in (mine, theirs))
        check(err <= DENSE_LOGP_TOL, f"hybrid greedy: {err:.4f} nats from the "
              f"dense f32 forward")
        del params32
        launches = dict(cuda_build.LAUNCHES)
        info_end = post(port, "/get_server_info", None)
        server_launches = {k_: info_end[f"kernel_launches/{k_}"]
                           - info0[f"kernel_launches/{k_}"] for k_ in SERVE_KERNELS}
        for name in SERVE_KERNELS:
            check(launches[name] > 0 and server_launches[name] > 0,
                  f"hybrid: {name} launches, trainer {launches[name]}, "
                  f"server {server_launches[name]}")
        for name in K4_NAMES:
            check(launches[name] > 0, f"hybrid: {name} was not launched")
        bottlenecks = [SEGMENTS[int(rec["critpath/bottleneck"])]
                       for rec in history]
        return dict(history=history, fit_wall=fit_wall, plane_ms=plane_ms,
                    local_tokens=local_tokens, server_tokens=server_tokens,
                    releases=fit_releases, abort_local=abort_local,
                    abort_server=abort_server, window_s=window_s,
                    release_wait_s=release_wait_s,
                    abort_salvaged=eng.tokens_salvaged - salv0,
                    pool_gb=pool_bytes / 1e9, drop_gb=drop / 1e9,
                    greedy=dict(bitwise=mine["tokens"] == theirs["tokens"],
                                first=first, tie=tie, gap=gap, dense_err=err),
                    trainer_launches={k_: launches[k_] for k_ in
                                      SERVE_KERNELS + K4_NAMES},
                    server_launches=server_launches, trainer_peak=trainer_peak,
                    server_peak=info_end.get("peak_memory_bytes", 0) / 1e9,
                    bottlenecks=bottlenecks,
                    disagg=[rec["perf/step_time_s"] for rec in disagg["history"]],
                    disagg_bubble=[rec["perf/trainer_bubble_s"]
                                   for rec in disagg["history"]],
                    disagg_budget=[rec["training/max_local_gen_s"]
                                   for rec in disagg["history"]],
                    colocated=[rec["perf/step_time_s"]
                               for rec in trained["history"]],
                    spans=len(obs.get_tracer().records()))
    finally:
        obs.configure(trace=False, reset=True)
        stop_servers(procs)
        for fn in reversed(cleanup):
            fn()


def stop_servers(procs: list) -> None:
    """Shut the server subprocesses down: ``/shutdown`` stops the server
    (its engine, receiver and listener, in that order) but not its
    process, which sleeps on; once the listener has closed (at most 30 s)
    the process is terminated, and killed if it does not end."""
    for proc, port, _ in procs:
        if proc.poll() is not None:
            continue
        try:
            post(port, "/shutdown", {})
            t0 = time.monotonic()
            while serving(port, "/health") and time.monotonic() - t0 < 30:
                time.sleep(0.1)
        except Exception:  # noqa: BLE001 -- terminated below
            pass
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


def hybrid_lines(h: dict, smi: str) -> list[str]:
    lines = []
    for i, rec in enumerate(h["history"], 1):
        rel = h["releases"][i - 1] if i - 1 < len(h["releases"]) else {}
        prev = h["releases"][i - 2]["capture_s"] if i > 1 and len(h["releases"]) > 1 else 0.0
        lines.append(
            f"hybrid ({smi}, this run): step {i}: wall {rec['perf/step_time_s']:.2f} s "
            f"(disagg {h['disagg'][i - 1]:.2f}, colocated {h['colocated'][i - 1]:.2f}); "
            f"bubble {rec['perf/trainer_bubble_s']:.2f} s (disagg "
            f"{h['disagg_bubble'][i - 1]:.2f}); max_local_gen_s "
            f"{rec['training/max_local_gen_s']:.2f} (disagg "
            f"{h['disagg_budget'][i - 1]:.2f}); critical path bottleneck "
            f"{h['bottlenecks'][i - 1]}; the local engine's recapture s this "
            f"phase {rel.get('capture_s', float('nan')) - prev:.3f}, KV "
            f"released {rel.get('drop_gb', float('nan')):.3f} GB")
        lines.append(f"hybrid ({smi}, this run): step {i} goodput: "
                     f"{goodput_split(rec)}; the planes' host ms "
                     f"{h['plane_ms'][i - 1]:.3f}")
    share = h["local_tokens"] / max(h["local_tokens"] + h["server_tokens"], 1)
    g_ = h["greedy"]
    lines.append(
        f"hybrid ({smi}, this run): tokens served locally {h['local_tokens']} "
        f"of {h['local_tokens'] + h['server_tokens']} ({share:.3f}); the "
        f"{HYBRID_WINDOW_S} s window's stream: {h['abort_local']} tokens local, "
        f"{h['abort_server']} on the server, {h['abort_salvaged']} salvaged "
        f"locally, in {h['window_s']:.2f} s, the KV released "
        f"{h['release_wait_s']:.2f} s after; KV round trip: pool "
        f"{h['pool_gb']:.3f} GB, released {h['drop_gb']:.3f} GB; greedy local "
        f"against the server: bitwise {g_['bitwise']} (first mismatch "
        f"{g_['first']}, first near-tie {g_['tie']}), dense f32 "
        f"{g_['dense_err']:.4f} nats; peaks trainer {h['trainer_peak']:.2f} GB, "
        f"server {h['server_peak']:.2f} GB; launches trainer "
        f"{json.dumps(h['trainer_launches'])}, server "
        f"{json.dumps(h['server_launches'])}; {h['spans']} spans traced")
    return lines


# -- LoRA delta sync (trainer.weight_sync=lora_delta, serve --lora-rank) -----

LORA_DELTA_ARGS = ["--lora-rank", str(LORA_RANK), "--lora-alpha", "16"]


def lora_delta_phase(dev, disagg: dict) -> dict:
    """LoRA delta sync: ``build_trainer`` at the train phase's configuration
    (REMOTE_CUT_LAYERS layers, the server too) with ``actor.lora_rank=16
    actor.lora_alpha=16 trainer.weight_sync=lora_delta
    rollout.mode=disaggregated``, and a
    server from ``serve``'s command line with ``--lora-rank 16
    --lora-alpha 16`` (in this process, ``serve.server_from_args``, so
    that its tensors can be read). Gates: finite losses, grad norms > 0;
    each push's entries the adapter tree's bytes, reckoned from the
    shapes; at each install the server's ``a``/``b`` bitwise the pushed
    adapters and, after the fit, the actor's, its bases bitwise the
    actor's frozen (seeded) base, every leaf at its old ``data_ptr()``, no
    decode graph captured again; a greedy request through the manager
    equal to an in-process ``CBEngine`` on the same wrapped tree (or
    parting only at a near-tie) and within DENSE_LOGP_TOL of the dense f32
    forward on ``merge_lora`` of it; the fused prologue, K2 and K3 in the
    server, K4 in the trainer. Logs each push's pack, wire and install
    seconds and GB/s against the disagg phase's full push, and the LoRA
    decode step's kernels and device ms against bf16 by replay."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
    from polyrl_tpu_torch.models import lora, quant
    from polyrl_tpu_torch.rollout import serve
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.train import build_trainer

    sup = ManagerSupervisor(bind_addr="127.0.0.1:0", extra_args=[
        "--health-check-interval-s", "0.5", "--stats-poll-interval-s", "0.5"])
    sup.start()
    cleanup: list = [sup.stop]
    srv = None
    try:
        cfg = load_config(None, REMOTE_OVERRIDES + [
            "rollout.mode=disaggregated",
            f"rollout.manager_endpoint={sup.endpoint}",
            "rollout.transfer_streams=4", f"actor.lora_rank={LORA_RANK}",
            "actor.lora_alpha=16", "trainer.weight_sync=lora_delta",
            f"device={dev.type}"])
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        remote, iface = trainer.rollout, trainer.rollout.transfer
        mcfg = trainer.actor.model_cfg
        want_bytes = sum(t.numel() * t.element_size() for _, t in
                         quant.named_leaves(lora.adapter_template(mcfg, LORA_RANK)))
        entry_bytes = sum(e.nbytes for e in iface.layout.entries)
        check(entry_bytes == want_bytes, f"lora_delta: the push layout holds "
              f"{entry_bytes} B, the adapter tree {want_bytes} B")
        args = serve.parse_args([
            "--model", MODEL, "--dtype", "bfloat16", "--device", dev.type,
            "--host", "127.0.0.1", "--port", "0", "--seed", "0",
            "--manager-endpoint", sup.endpoint, "--transfer-streams", "4",
            "--num-pages", str(DISAGG_PAGES)] + DISAGG_SERVER + LORA_DELTA_ARGS)
        srv = serve.server_from_args(
            args, model_overrides={"num_layers": REMOTE_CUT_LAYERS})
        seng = srv.engine
        check(srv.receiver is not None and srv.receiver.layout == iface.layout,
              "lora_delta: the server's receiver has another layout")
        remote.pool.wait_for_member(srv.endpoint, DISAGG_SERVER_DEADLINE_S,
                                    active=False)
        ptrs = {n: t.data_ptr() for n, t in quant.named_leaves(seng.params)}
        # at each push: the adapters pushed (the trainer side) and, at its
        # install, whether the server's live a/b equal them and its graphs
        # survived (the server side)
        pushed: dict[int, dict] = {}
        installs: list[dict] = []
        push = remote.update_weights

        def recording_push(params, version=None):
            # recorded first: the server may install before the push returns
            want = remote.weight_version + 1
            pushed[want] = _tree_map(lambda t: t.detach().clone(), params)
            v = push(params, version)
            check(v == want, f"lora_delta: pushed v{v}, expected v{want}")
            return v

        install = srv.update_weights_from_agent

        def checked_install(version):
            graphs = dict(seng._graphs)
            captures = seng.graph_captures
            t_i = time.monotonic()
            ok, err = install(version)
            wall = time.monotonic() - t_i
            v = seng.weight_version
            live = seng.params["layers"]
            installs.append(dict(
                version=v, ok=ok, err=err, wall_s=wall,
                graphs_kept=all(seng._graphs.get(k_) is g_
                                for k_, g_ in graphs.items()),
                captures=seng.graph_captures - captures,
                ptrs=ptrs == {n: t.data_ptr() for n, t in
                              quant.named_leaves(seng.params)},
                equal=(v in pushed and all(
                    torch.equal(getattr(live[k_], f_), ab[f_])
                    for k_, ab in pushed[v]["layers"].items()
                    for f_ in ("a", "b")))))
            return ok, err

        remote.update_weights = recording_push
        srv.update_weights_from_agent = checked_install
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t0
        n_steps = cfg.trainer.total_steps
        check(len(history) == n_steps, "the lora_delta fit did not finish")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"lora_delta step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0, f"lora_delta step {i}: zero gradient")
        plane_gates(history, "lora_delta")
        final = remote.weight_version
        t1 = time.monotonic()
        while seng.weight_version < final:
            check(time.monotonic() - t1 < 120, "lora_delta: the last push never landed")
            time.sleep(0.1)
        check(len(installs) == final and all(
            i_["ok"] and i_["equal"] and i_["ptrs"] and i_["graphs_kept"]
            and i_["captures"] == 0 for i_ in installs),
              f"lora_delta: installs {[{k_: v for k_, v in i_.items() if k_ != 'err'} for i_ in installs]}")
        actor_layers = trainer.actor.params["layers"]
        moved = False
        for (name, t), (_, want) in zip(_leaves(_plain_view(seng.params)),
                                        _leaves(_plain_view(trainer.actor.params))):
            check(torch.equal(t, want.detach()),
                  f"lora_delta: the server's {name} differs from the actor's")
        for k_, w in actor_layers.items():
            if isinstance(w, quant.LoraWeight):
                moved |= bool(w.b.detach().abs().sum() > 0)
        check(moved, "lora_delta: the adapters never moved")
        check(len(seng._graphs) == seng.graph_captures,
              f"lora_delta: {seng.graph_captures} captures of "
              f"{len(seng._graphs)} graphs")
        # a greedy request through the manager against an in-process engine
        # on the same wrapped tree
        rng = np.random.default_rng(5)
        prompt = rng.integers(1, mcfg.vocab_size, 40).tolist()
        served = remote.manager.generate("ldgreedy", prompt, {
            "temperature": 0.0, "max_new_tokens": DISAGG_GREEDY})
        check(served.success, f"lora_delta greedy: {served.error}")
        # a GRPO group on a full-page prompt (K3) through the manager
        from polyrl_tpu_torch.manager.client import GenerateProgress

        group_prompt = rng.integers(1, mcfg.vocab_size, 100).tolist()
        finals = [r for r in remote.manager.batch_generate_stream([
            {"rid": f"ldg{i}", "input_ids": group_prompt, "group_id": "ldgrp",
             "group_size": 8, "sampling_params": {"temperature": 1.0,
                                                  "max_new_tokens": 64}}
            for i in range(8)]) if not isinstance(r, GenerateProgress)]
        check(len(finals) == 8 and all(r.success and len(r.output_token_ids) == 64
                                       for r in finals),
              "lora_delta: the GRPO group through the manager failed")
        # one process: every decode launch since the reset is the server's
        # (the trainer runs no engine), every K4 launch the trainer's
        launches = dict(cuda_build.LAUNCHES)
        server_launches = {k_: launches[k_] for k_ in SERVE_KERNELS}
        for name in SERVE_KERNELS:
            check(launches[name] > 0,
                  f"lora_delta: {name} was not launched in the server")
        for name in K4_NAMES:
            check(launches[name] > 0, f"lora_delta: {name} was not launched")
        eng = CBEngine(mcfg, seng.params, pad_token_id=0,
                       kv_cache_dtype=torch.bfloat16, max_slots=64, page_size=64,
                       max_seq_len=512, num_pages=64, steps_per_dispatch=8,
                       prompt_buckets=(64, 128), seed=0, device=dev)
        try:
            ref = eng.generate([prompt], SamplingParams(
                temperature=0.0, max_new_tokens=DISAGG_GREEDY))[0]
        finally:
            eng.stop()
        del eng
        params32 = f32_copy(lora.merge_lora(seng.params))
        gaps = top2_gaps(params32, mcfg, prompt, ref["token_ids"], dev)
        ok, first, tie, gap = agrees_until_tie(served.output_token_ids,
                                               list(ref["token_ids"]), gaps)
        check(ok, f"lora_delta greedy: the manager's tokens part from the "
              f"in-process engine's at {first} (first near-tie {tie}, gap {gap:.4f})")
        err, _ = dense_f32_gate(params32, mcfg, prompt, served.output_token_ids,
                                served.output_token_logprobs, dev)
        check(err <= DENSE_LOGP_TOL, f"lora_delta greedy: {err:.4f} nats from "
              "the dense f32 forward on merge_lora")
        del params32
        syncs = {s_["version"]: s_ for s_ in srv.weight_syncs}
        rounds = {r_["version"]: r_ for r_ in iface.sender.round_log}
        pushes = []
        for pl in iface.push_log:
            v = pl["version"]
            sy, rd = syncs.get(v, {}), rounds.get(v, {})
            pushes.append(dict(version=v, bytes=sy.get("bytes", rd.get("bytes", 0)),
                               pack_s=pl["pack_s"], wire_s=rd.get("push_s", float("nan")),
                               install_s=sy.get("install_s", float("nan")),
                               swap_s=sy.get("swap_s", float("nan"))))
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        # the LoRA-wrapped decode step against bf16 by replay
        plain = _plain_view(seng.params, base_only=True)
        ab = quant_decode_ab(dev, mcfg, {"bf16": plain, "lora": seng.params},
                             tag="lora_delta")
        return dict(history=history, fit_wall=fit_wall, pushes=pushes,
                    installs=installs, want_bytes=want_bytes,
                    layout_bytes=iface.layout.total_bytes,
                    full=disagg["pushes"], ab=ab, peak_gb=peak,
                    server_launches=server_launches,
                    trainer_launches={k_: launches[k_] for k_ in K4_NAMES},
                    greedy=dict(bitwise=served.output_token_ids == list(ref["token_ids"]),
                                first=first, tie=tie, gap=gap, dense_err=err))
    finally:
        if srv is not None:
            srv.stop()
        for fn in reversed(cleanup):
            fn()


def _plain_view(params: dict, base_only: bool = False) -> dict:
    """A wrapped tree's leaves by name (``base`` for a LoRA weight's base,
    ``a``/``b`` beside it), or with ``base_only`` the plain tree of its
    bases: the same tensors, no copy."""
    from polyrl_tpu_torch.models.quant import LoraWeight

    layers = {}
    for k_, w in params["layers"].items():
        if not isinstance(w, LoraWeight):
            layers[k_] = w
        elif base_only:
            layers[k_] = w.base
        else:
            layers.update({f"{k_}.base": w.base, f"{k_}.a": w.a, f"{k_}.b": w.b})
    return {**params, "layers": layers}


def lora_delta_lines(d: dict, smi: str) -> list[str]:
    lines = []
    full = [p_ for p_ in d["full"] if p_["version"] > 1]
    fw = statistics.median(p_["wire_s"] for p_ in full) if full else float("nan")
    fb = full[0]["bytes"] / 1e9 if full else float("nan")
    for p_ in d["pushes"]:
        gb = p_["bytes"] / 1e9
        lines.append(
            f"lora_delta ({smi}, this run): push v{p_['version']}: {gb * 1e3:.3f} MB "
            f"(adapter tree {d['want_bytes'] / 1e6:.3f} MB from the shapes, layout "
            f"{d['layout_bytes'] / 1e6:.3f} MB); pack {p_['pack_s']:.4f} s "
            f"({gb / p_['pack_s']:.2f} GB/s), wire {p_['wire_s']:.4f} s "
            f"({gb / p_['wire_s']:.2f} GB/s), install {p_['install_s']:.4f} s, "
            f"swap {p_['swap_s']:.4f} s; against the disagg phase's full push of "
            f"{fb:.3f} GB, wire median {fw:.3f} s")
    for i, rec in enumerate(d["history"], 1):
        lines.append(f"lora_delta ({smi}, this run): step {i}: wall "
                     f"{rec['perf/step_time_s']:.2f} s, bubble "
                     f"{rec['perf/trainer_bubble_s']:.2f} s; goodput "
                     f"{goodput_split(rec)}")
    g_ = d["greedy"]
    lines.append(
        f"lora_delta ({smi}, this run): installs {len(d['installs'])}, each "
        f"bitwise the pushed adapters at the old addresses, no recapture; "
        f"greedy through the manager against an in-process engine on the "
        f"wrapped tree: bitwise {g_['bitwise']} (first mismatch {g_['first']}, "
        f"near-tie {g_['tie']}), dense f32 on merge_lora {g_['dense_err']:.4f} "
        f"nats; decode step by replay bf16 / LoRA: device ms "
        f"{d['ab']['bf16']['device_ms']:.3f} / {d['ab']['lora']['device_ms']:.3f}, "
        f"kernels {d['ab']['bf16']['kernels']:.1f} / {d['ab']['lora']['kernels']:.1f}, "
        f"wall ms {d['ab']['bf16']['wall_ms']:.2f} / {d['ab']['lora']['wall_ms']:.2f}; "
        f"peak {d['peak_gb']:.2f} GB (trainer and server in one process); "
        f"launches server {json.dumps(d['server_launches'])}, trainer "
        f"{json.dumps(d['trainer_launches'])}")
    return lines


AUTOSCALE_STEPS = 5
# the spot notice's grace: /drain, then this long for the drained server's
# run-ahead (up to 16 dispatches of 8 tokens a request) to flush its
# partials before the server is deregistered; the phase measures the
# flush and fails if it outlasts the grace (H100: 1.43 s for 8 requests)
AUTOSCALE_GRACE_S = 3.0
# the servers' and the manager's state polled through the fit, every s
AUTOSCALE_POLL_S = 0.1
# the servers' prompt buckets: a suffix resume re-issues prompt + the
# tokens salvaged so far (up to 64 + 447), so they reach max_seq_len
AUTOSCALE_SERVER = ["--num-pages", str(DISAGG_PAGES), "--prompt-buckets",
                    "64", "128", "256", "512"]
AUTOSCALE_GROUP_PROMPT = 100  # one full page shared by a GRPO group (K3)


def autoscale_overrides(manager_ep: str, trace: str) -> list[str]:
    """The disagg phase's cell, pipelined one step ahead for 5 steps, with
    the autoscaler on a [2, 2] envelope, a step-paced spot market reading
    ``trace``, and one trainer-side manager-stream kill."""
    return REMOTE_OVERRIDES + [
        "rollout.mode=disaggregated", f"rollout.manager_endpoint={manager_ep}",
        "rollout.transfer_streams=4", f"trainer.total_steps={AUTOSCALE_STEPS}",
        "trainer.pipeline_depth=1", "trainer.rollout_is_correction=true",
        "rollout.autoscale.enabled=true", "rollout.autoscale.min_engines=2",
        "rollout.autoscale.max_engines=2", "rollout.autoscale.hold_steps=1",
        "rollout.autoscale.cooldown_add_s=0",
        "rollout.autoscale.cooldown_drain_s=0",
        "rollout.autoscale.max_actions_per_hour=100",
        "rollout.autoscale.admission_max_wait_s=5",
        "rollout.spot_market.enabled=true", "rollout.spot_market.time_base=step",
        f"rollout.spot_market.grace_s={AUTOSCALE_GRACE_S}",
        f"rollout.spot_market.trace_path={trace}",
        "rollout.fault_injection.enabled=true",
        "rollout.fault_injection.stream_kill_times=1",
        "rollout.fault_injection.stream_kill_min_progress=1",
        "obs.statusz=true"]


def run_tool(name: str, arg: str) -> str:
    """``python -m polyrl_tpu_torch.tools.<name> <arg>``: exit 0 with output,
    or the phase fails."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-m", f"polyrl_tpu_torch.tools.{name}",
                          arg], cwd=root, env=env, capture_output=True,
                         text=True, timeout=120)
    check(out.returncode == 0 and out.stdout.strip(),
          f"{name} {arg}: rc {out.returncode}: {out.stderr[-1500:]}")
    return out.stdout


def autoscale_phase(dev, disagg: dict) -> dict:
    """Closed-loop autoscaling on the disaggregated fit: ``build_trainer``
    with the disagg phase's cell (a supervised manager, server A a
    ``serve`` subprocess registered through ``--manager-endpoint``) and
    ``autoscale_overrides``: 5 steps pipelined one step ahead, the
    controller on a [2, 2] envelope, a step-paced spot market whose trace
    offers server B (a ``serve`` subprocess started before the fit but in
    no pool) at step 1 and gives A a preemption notice at step 3, and one
    trainer-side stream kill. Before the fit one push and a GRPO group on
    a one-page prompt through the manager (A alone: K3); after it the same
    group and a greedy request (B alone). Gates: five finite records with
    no dropped group and every response at full length (or ended by EOS);
    ``autoscale/ticks`` 5 and one add, at step 1 (envelope repair from the
    offer), ``no_capacity`` on every tick after the notice; tier 0 and no
    admission wait throughout, no failed action; ``fault/spot_offers`` 1,
    ``fault/spot_notices`` 1, ``fault/suffix_resumes`` >= 1; the trainer's
    ``/statusz`` autoscale section with those totals and envelope {2, 2};
    B catching up through ``POST /attach_receiver`` and serving no token
    before its first install; A's drain flushed within the grace and A
    serving nothing after it; the greedy request on B equal to an
    in-process ``CBEngine`` on the trained weights (or parting only at a
    near-tie), within DENSE_LOGP_TOL of the dense f32 forward; the goodput
    and health planes in every record; launches: the fused prologue, K2
    and K3 in both servers, K4 forward and backward in the trainer and no
    decode kernel there; the controller's and the market's threads gone
    after cleanup; the port's ``fleet_report`` over the records and
    ``engine_report``/``kv_report`` over B's ``/statusz`` exit 0. Logs B's
    add to active (its bootstrap push's pack, wire, install), the drain's
    flush and grace, each step's wall, bubble and generation (dispatches
    and most running requests on both servers), the resumes, the decision
    trail and the three processes' peaks."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.manager.client import GenerateProgress
    from polyrl_tpu_torch.manager.supervisor import ManagerSupervisor
    from polyrl_tpu_torch.rollout.autoscale import ACTIONS, REASONS
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams
    from polyrl_tpu_torch.rollout.spotmarket import SpotMarket
    from polyrl_tpu_torch.train import build_trainer

    sup = ManagerSupervisor(bind_addr="127.0.0.1:0", extra_args=[
        "--health-check-interval-s", "0.5", "--stats-poll-interval-s", "0.5"]
        + MANAGER_ARGS)
    sup.start()
    cleanup: list = [sup.stop]
    procs: list = []
    tmp = tempfile.mkdtemp(prefix="autoscale-")
    try:
        # B first, in no pool: only the controller's add puts it there
        port_b, log_b, up_b = spawn_server(dev, None, None, AUTOSCALE_SERVER,
                                           procs)
        ep_b = f"127.0.0.1:{port_b}"
        port_a = free_port()
        ep_a = f"127.0.0.1:{port_a}"
        trace = os.path.join(tmp, "spot_trace.jsonl")
        with open(trace, "w") as f:
            f.write(json.dumps({"t": 1, "event": "offer", "name": "B",
                                "endpoint": ep_b}) + "\n")
            f.write(json.dumps({"t": 3, "event": "notice", "target": "A",
                                "endpoint": ep_a, "terminate": False}) + "\n")
        cfg = load_config(None, autoscale_overrides(sup.endpoint, trace)
                          + [f"device={dev.type}"])
        torch.cuda.reset_peak_memory_stats(dev)
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        remote, pool, ctl = trainer.rollout, trainer.rollout.pool, trainer._autoscale
        mgr, iface = remote.manager, remote.transfer
        check(ctl is not None and isinstance(ctl.capacity, SpotMarket),
              "autoscale: build_trainer armed no controller with a spot market")
        check(remote.fault_injector is not None
              and remote.fault_injector.spot is ctl.capacity,
              "autoscale: the spot counters do not ride the fault plane")
        _, _, up_a = spawn_server(dev, mgr, sup.endpoint, AUTOSCALE_SERVER,
                                      procs, port=port_a)
        info_a0 = post(port_a, "/get_server_info", None)
        info_b0 = post(port_b, "/get_server_info", None)
        check(info_b0["total_tokens_served"] == 0
              and all(info_b0[f"kernel_launches/{k_}"] == 0 for k_ in SERVE_KERNELS),
              "autoscale: B served before the phase")
        log(f"autoscale: servers up (A {up_a:.1f} s, registered; B {up_b:.1f} s, "
            f"in no pool); trace {json.dumps(open(trace).read().splitlines())}")

        # the main path: counts from zero in the trainer (the servers' from
        # info_*0), a push and a group on A alone, the fit, a group and a
        # greedy request on B alone
        cuda_build.reset_launch_counts()
        rng = np.random.default_rng(5)
        vocab = trainer.actor.model_cfg.vocab_size
        group_prompt = rng.integers(1, vocab, AUTOSCALE_GROUP_PROMPT).tolist()

        def group(tag: str, version: int) -> None:
            reqs = [{"rid": f"as{tag}{i}", "input_ids": group_prompt,
                     "group_id": f"asgrp{tag}", "group_size": 8,
                     "sampling_params": {"temperature": 1.0,
                                         "max_new_tokens": 64}}
                    for i in range(8)]
            finals = [r for r in mgr.batch_generate_stream(reqs)
                      if not isinstance(r, GenerateProgress)]
            check(len(finals) == 8 and all(
                r.success and len(r.output_token_ids) == 64
                and set(r.output_token_weight_versions) == {version}
                for r in finals),
                  f"autoscale: the GRPO group {tag} through the manager failed")

        v_pre = remote.update_weights(trainer.actor.export_params())
        pool.wait_for_member(ep_a, 120.0)
        group("pre", v_pre)
        info_a_pre = post(port_a, "/get_server_info", None)
        check(post(port_b, "/get_server_info", None)["total_tokens_served"] == 0,
              "autoscale: B served before the controller added it")

        # instrumentation: the pool's actions, each tick's decision, each
        # stream, and the servers' and manager's state through the fit
        acts: list[dict] = []
        for verb in ("add_engine", "preempt"):
            inner_ = getattr(pool, verb)

            def timed(*a, _inner=inner_, _verb=verb, **kw):
                row = dict(verb=_verb, t0=time.time(), args=a, kw=kw)
                acts.append(row)
                try:
                    return _inner(*a, **kw)
                finally:
                    row["t1"] = time.time()
            setattr(pool, verb, timed)
        trail: list[dict] = []
        tick = ctl.tick

        def traced_tick(step, **kw):
            t0_ = time.time()
            out_ = tick(step, **kw)
            trail.append(dict(step=step, wall_s=time.time() - t0_,
                              last=ctl.statusz_section()["last"]))
            return out_
        ctl.tick = traced_tick
        streamed: list[tuple[int, object]] = []
        streams: list[list] = []
        gen_inner = remote.generate_stream

        def recording_stream(*a, **kw):
            start = remote.weight_version
            span = [time.time(), time.time(), start]
            streams.append(span)
            for chunk in gen_inner(*a, **kw):
                streamed.extend((start, r) for _, r in chunk)
                span[1] = time.time()
                yield chunk
        remote.generate_stream = recording_stream
        timeline: list[dict] = []
        poll_err: list[BaseException] = []
        polled = threading.Event()
        poller = threading.Thread(
            target=autoscale_poll, name="autoscale-poll", daemon=True,
            args=({"a": port_a, "b": port_b}, mgr, timeline, polled, poll_err))
        poller.start()
        plane_ms = plane_timers(trainer)
        t_fit = time.monotonic()
        try:
            history = trainer.fit()
        finally:
            polled.set()
            poller.join(timeout=30)
            remote.generate_stream = gen_inner
        fit_wall = time.monotonic() - t_fit
        check(not poll_err, f"autoscale: polling failed: {poll_err}")
        n = cfg.trainer.total_steps
        check(len(history) == n, "the autoscaled fit did not finish")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(key in rec and np.isfinite(rec[key]),
                      f"autoscale step {i}: {key} missing or not finite")
            check(rec["fault/dropped_groups"] == 0,
                  f"autoscale step {i}: dropped groups")
            check(rec["autoscale/degrade_tier"] == 0.0
                  and rec["autoscale/admission_gate_wait_s"] == 0.0
                  and rec["autoscale/exec_failures"] == 0.0,
                  f"autoscale step {i}: tier {rec['autoscale/degrade_tier']}, "
                  f"gate wait {rec['autoscale/admission_gate_wait_s']}, "
                  f"failures {rec['autoscale/exec_failures']}")
        plane_gates(history, "autoscale")
        last = history[-1]
        check(last["autoscale/ticks"] == n and last["autoscale/adds_total"] == 1
              and last["autoscale/drains_total"] == 0,
              f"autoscale: ticks {last['autoscale/ticks']}, adds "
              f"{last['autoscale/adds_total']}, drains {last['autoscale/drains_total']}")
        check(history[0]["autoscale/action"] == ACTIONS.index("add")
              and history[0]["autoscale/reason"] == REASONS.index("below_min"),
              f"autoscale: step 1 decided {history[0]['autoscale/action']} "
              f"for {history[0]['autoscale/reason']}, not add for below_min")
        check(len(trail) == n and all(
            "no_capacity" in t_["last"]["suppressions"] for t_ in trail[2:]),
              f"autoscale: no no_capacity after the notice: {trail}")
        check(last["fault/spot_offers"] == 1 and last["fault/spot_notices"] == 1
              and last["fault/spot_kills"] == 0
              and last["fault/suffix_resumes"] >= 1,
              "autoscale: spot and resume counters "
              + json.dumps({k_: v_ for k_, v_ in last.items()
                            if k_.startswith("fault/")}))
        check(ctl.capacity.done.is_set(), "autoscale: the trace did not replay")
        full = cfg.trainer.max_response_length
        eos = trainer.tokenizer.eos_token_id
        short = [(len(r.output_token_ids), r.finish_reason) for _, r in streamed
                 if len(r.output_token_ids) != full
                 and not (r.output_token_ids and r.output_token_ids[-1] == eos)]
        per_step = cfg.trainer.train_batch_size * cfg.trainer.rollout_n
        check(len(streamed) == n * per_step and not short,
              f"autoscale: {len(streamed)} results, short ones {short}")
        final = remote.weight_version
        untagged = [r.output_token_weight_versions for _, r in streamed
                    if len(r.output_token_weight_versions) != len(r.output_token_ids)
                    or any(not 1 <= v <= final
                           for v in r.output_token_weight_versions)]
        check(not untagged, f"autoscale: tokens untagged or of no pushed "
              f"version in {len(untagged)} results")
        # the trainer's /statusz
        sz = json.loads(get_text(
            int(trainer._statusz.endpoint.rsplit(":", 1)[1]), "/statusz"))
        auto = sz["autoscale"]
        check(auto["envelope"] == {"min": 2, "max": 2}
              and auto["totals"]["adds"] == 1 and auto["totals"]["ticks"] == n
              and auto["totals"]["exec_failures"] == 0
              and auto["degrade_tier"] == 0,
              f"autoscale: the trainer's /statusz section {json.dumps(auto)}")

        # B: added by the controller at step 1, caught up, and serving only
        # from its first install on
        adds = [a_ for a_ in acts if a_["verb"] == "add_engine"]
        notices = [a_ for a_ in acts if a_["verb"] == "preempt"]
        check(len(adds) == 1 and adds[0]["kw"].get("endpoint") == ep_b
              and len(notices) == 1 and notices[0]["args"][0] == ep_a,
              f"autoscale: pool actions {[(a_['verb'], a_['args'], a_['kw']) for a_ in acts]}")
        info_b = post(port_b, "/get_server_info", None)
        syncs_b = info_b.get("weight_syncs", [])
        check(bool(syncs_b), "autoscale: B logged no install")
        first_sync = min(syncs_b, key=lambda s_: s_["t_wall"])
        b_rows = [r_["b"] | {"t": r_["t"]} for r_ in timeline if r_["b"]]
        check(b_rows and not any(b_["tokens"] > 0 and (
            b_["t"] < first_sync["t_wall"] or b_["version"] < 1)
            for b_ in b_rows),
              "autoscale: B served tokens before its first install")
        active_b = next((r_["t"] for r_ in timeline if ep_b in r_["active"]),
                        float("nan"))
        check(np.isfinite(active_b), "autoscale: B never joined the routing set")
        b_fit_tokens = b_rows[-1]["tokens"]
        check(b_fit_tokens > 0, "autoscale: B served nothing in the fit")
        rounds_b = [r_ for r_ in iface.sender.round_log if r_["instance"] == ep_b]
        boot = rounds_b[0] if rounds_b else {}
        pack = {p_["version"]: p_ for p_ in iface.push_log}.get(
            first_sync["version"], {})
        # A: drained at step 3's tick, flushed within the grace (running
        # nothing), then idle; its streams' abort terminals are a
        # preemption, so the manager neither evicts it nor shuts it down
        # (the eviction count is read after the drain, not gated)
        nt = notices[0]
        after = [r_ for r_ in timeline if r_["t"] >= nt["t0"]]
        flushed = next((r_["t"] for r_ in after
                        if not r_["a"] or r_["a"]["running"] == 0), float("nan"))
        flush_s = flushed - nt["t0"]
        check(flush_s <= AUTOSCALE_GRACE_S,
              f"autoscale: A's drain flushed in {flush_s:.2f} s, past the "
              f"{AUTOSCALE_GRACE_S} s grace")
        a_rows = [r_["a"] | {"t": r_["t"]} for r_ in timeline if r_["a"]]
        a_last = a_rows[-1]
        a_after = [a_ for a_ in a_rows if a_["t"] >= nt["t1"]]
        check(ep_a not in timeline[-1]["active"]
              and all(a_["tokens"] == a_after[0]["tokens"] for a_ in a_after),
              "autoscale: A still routed, or serving, after its notice")
        a_down = next((r_["t"] - nt["t0"] for r_ in after if not r_["a"]), None)
        t3 = time.monotonic()
        while not any(i["endpoint"] == ep_b and i["active"]
                      and i.get("weight_version", final) >= final
                      for i in mgr.get_instances_status()["instances"]):
            check(time.monotonic() - t3 < 120,
                  f"autoscale: B never came back at v{final}: {_tail(log_b)}")
            time.sleep(0.1)
        group("post", final)
        greedy_prompt = rng.integers(1, vocab, 40).tolist()
        served = mgr.generate("asgreedy", greedy_prompt,
                              {"temperature": 0.0, "max_new_tokens": DISAGG_GREEDY})
        check(served.success and set(served.output_token_weight_versions) == {final},
              f"autoscale greedy: {served.error}")
        info_a = server_info_or_none(port_a)
        info_b = post(port_b, "/get_server_info", None)
        evictions = mgr.get_instances_status()["pool"]["evictions"]
        check(info_a is None or info_a["total_tokens_served"] == a_last["tokens"],
              "autoscale: A served tokens after its drain")
        launches = dict(cuda_build.LAUNCHES)
        # A's last reading (the manager may have shut it down)
        a_launch = {k_: a_last["launches"][k_] - info_a0[f"kernel_launches/{k_}"]
                    for k_ in SERVE_KERNELS}
        b_launch = {k_: info_b[f"kernel_launches/{k_}"] - info_b0[f"kernel_launches/{k_}"]
                    for k_ in SERVE_KERNELS}
        for name in SERVE_KERNELS:
            check(a_launch[name] > 0 and b_launch[name] > 0,
                  f"autoscale: {name} launches A {a_launch[name]}, B {b_launch[name]}")
        for name in K4_NAMES:
            check(launches[name] > 0, f"autoscale: {name} was not launched")
        check(all(launches[k_] == 0 for k_ in SERVE_KERNELS),
              f"autoscale: the trainer process decoded: {json.dumps(launches)}")
        trainer_peak = torch.cuda.max_memory_allocated(dev) / 1e9
        peaks = dict(trainer=trainer_peak, a=a_last["peak"] / 1e9,
                     b=info_b.get("peak_memory_bytes", 0) / 1e9)
        # the reports over this phase's records and B's /statusz
        steps_path = os.path.join(tmp, "steps.jsonl")
        with open(steps_path, "w") as f:
            f.writelines(json.dumps(r_) + "\n" for r_ in history)
        reports = {"fleet_report": run_tool("fleet_report", steps_path),
                   "engine_report": run_tool("engine_report", ep_b),
                   "kv_report": run_tool("kv_report", ep_b)}
        # A is done: its memory goes before the in-process engine's
        stop_servers([p_ for p_ in procs if p_[1] == port_a])

        params = trainer.actor.export_params()
        mcfg = trainer.actor.model_cfg
        eng = CBEngine(mcfg, params, pad_token_id=0, kv_cache_dtype=torch.bfloat16,
                       max_slots=64, page_size=64, max_seq_len=512,
                       num_pages=DISAGG_PAGES, steps_per_dispatch=8,
                       prompt_buckets=(64, 128), seed=0, device=dev)
        try:
            local = eng.generate([greedy_prompt], SamplingParams(
                temperature=0.0, max_new_tokens=DISAGG_GREEDY))[0]
        finally:
            eng.stop()
        del eng
        params32 = f32_copy(params)
        gaps = top2_gaps(params32, mcfg, greedy_prompt, local["token_ids"], dev)
        ok, first, tie, gap = agrees_until_tie(served.output_token_ids,
                                               list(local["token_ids"]), gaps)
        check(ok, f"autoscale greedy: B parts from the in-process engine at "
              f"{first} (first near-tie {tie}, f32 gap {gap:.4f})")
        err, _ = dense_f32_gate(params32, mcfg, greedy_prompt,
                                served.output_token_ids,
                                served.output_token_logprobs, dev)
        check(err <= DENSE_LOGP_TOL, f"autoscale greedy: {err:.4f} nats from "
              "the dense f32 forward")
        del params32
        gen = autoscale_generation(streams, timeline)
        out = dict(
            history=history, fit_wall=fit_wall, plane_ms=plane_ms, trail=trail,
            acts=[{k_: v_ for k_, v_ in a_.items() if k_ not in ("args", "kw")}
                  for a_ in acts],
            join=dict(add_s=adds[0]["t1"] - adds[0]["t0"],
                      active_s=active_b - adds[0]["t0"],
                      version=first_sync["version"],
                      pack_s=pack.get("pack_s", float("nan")),
                      wire_s=boot.get("push_s", float("nan")),
                      bytes=boot.get("bytes", first_sync.get("bytes", 0)),
                      install_s=first_sync.get("install_s", float("nan")),
                      swap_s=first_sync.get("swap_s", float("nan")),
                      raised_s=first_sync["t_wall"] - adds[0]["t0"]),
            drain=dict(flush_s=flush_s, preempt_s=nt["t1"] - nt["t0"],
                       grace_s=AUTOSCALE_GRACE_S, down_s=a_down,
                       evictions=evictions,
                       salvaged=a_last["salvaged"]
                       - info_a_pre.get("tokens_salvaged", 0),
                       drained=a_last["drained"]),
            gen=gen, b_fit_tokens=b_fit_tokens,
            a_launches=a_launch, b_launches=b_launch,
            trainer_launches={k_: launches[k_] for k_ in SERVE_KERNELS + K4_NAMES},
            peaks=peaks, reports={k_: len(v_.splitlines()) for k_, v_ in reports.items()},
            greedy=dict(bitwise=served.output_token_ids == list(local["token_ids"]),
                        logprobs_bitwise=served.output_token_logprobs
                        == list(local["logprobs"]),
                        first=first, tie=tie, gap=gap, dense_err=err),
            disagg=[rec["perf/step_time_s"] for rec in disagg["history"]],
            statusz=auto)
    finally:
        stop_servers(procs)
        for fn in reversed(cleanup):
            fn()
        shutil.rmtree(tmp, ignore_errors=True)
    alive = [t_.name for t_ in threading.enumerate()
             if t_.name in ("autoscale-exec", "spot-market", "spot-notice")]
    check(not alive, f"autoscale: threads left after cleanup: {alive}")
    return out


def server_info_or_none(port: int) -> dict | None:
    """A server's ``/get_server_info``, or None when it no longer answers."""
    try:
        return post(port, "/get_server_info", None)
    except OSError:
        return None


def autoscale_poll(ports: dict, mgr, timeline: list, stop: threading.Event,
                   err: list) -> None:
    """Every AUTOSCALE_POLL_S until ``stop``: each server's state (an empty
    dict once it no longer answers) and the manager's routing set."""
    try:
        while not stop.is_set():
            row: dict = dict(t=time.time())
            for tag, p_ in ports.items():
                inf = server_info_or_none(p_)
                row[tag] = {} if inf is None else dict(
                    version=inf["weight_version"],
                    running=inf["num_running_reqs"],
                    tokens=inf["total_tokens_served"],
                    dispatches=inf["decode_dispatches"],
                    salvaged=inf.get("tokens_salvaged", 0),
                    drained=inf.get("drained_requests", 0),
                    peak=inf.get("peak_memory_bytes", 0),
                    launches={k_: inf[f"kernel_launches/{k_}"]
                              for k_ in SERVE_KERNELS})
            row["active"] = sorted(
                i["endpoint"] for i in mgr.get_instances_status()["instances"]
                if i["active"])
            timeline.append(row)
            stop.wait(AUTOSCALE_POLL_S)
    except BaseException as exc:  # noqa: BLE001 -- checked by the phase
        err.append(exc)


def autoscale_generation(streams: list, timeline: list) -> list[dict]:
    """Each stream's generation on both servers: its wall, the decode
    dispatches of A and B between its start and end, and the most requests
    running on them together (to the poll's resolution)."""
    out = []
    for s0, s1, v in streams:
        rows = [r_ for r_ in timeline
                if s0 - AUTOSCALE_POLL_S <= r_["t"] <= s1 + AUTOSCALE_POLL_S]
        row = dict(version=v, stream_s=s1 - s0)
        for tag in ("a", "b"):
            seen = [r_[tag] for r_ in rows if r_[tag]]
            if len(seen) >= 2:
                row[f"dispatches_{tag}"] = seen[-1]["dispatches"] - seen[0]["dispatches"]
                row[f"tokens_{tag}"] = seen[-1]["tokens"] - seen[0]["tokens"]
        row["peak_running"] = max((sum(r_[t_].get("running", 0) for t_ in ("a", "b"))
                                   for r_ in rows), default=None)
        out.append(row)
    return out


def autoscale_lines(d: dict, smi: str) -> list[str]:
    from polyrl_tpu_torch.rollout.autoscale import ACTIONS, REASONS

    j_ = d["join"]
    gb = j_["bytes"] / 1e9
    lines = [
        f"autoscale ({smi}, this run): B added at step 1's tick: register + "
        f"attach {j_['add_s']:.3f} s, active after {j_['active_s']:.2f} s; its "
        f"bootstrap push v{j_['version']}: {gb:.3f} GB, pack {j_['pack_s']:.4f} s "
        f"(the version's, shared), wire {j_['wire_s']:.3f} s, install "
        f"{j_['install_s']:.4f} s, swap {j_['swap_s']:.4f} s, version raised "
        f"{j_['raised_s']:.2f} s after the add",
        f"autoscale ({smi}, this run): A's notice at step 3: drain flushed in "
        f"{d['drain']['flush_s']:.3f} s (grace {d['drain']['grace_s']} s; A "
        + (f"shut down by the manager {d['drain']['down_s']:.3f} s after the drain"
           if d["drain"]["down_s"] is not None else "still up")
        + "), the "
        f"preempt {d['drain']['preempt_s']:.3f} s on the trainer's thread; A "
        f"drained {d['drain']['drained']} requests, salvaged "
        f"{d['drain']['salvaged']} tokens; the manager's evictions after the "
        f"drain {d['drain']['evictions']}; B served {d['b_fit_tokens']} tokens "
        f"in the fit"]
    for i, rec in enumerate(d["history"], 1):
        t_ = d["trail"][i - 1]
        g_ = d["gen"][i - 1] if i - 1 < len(d["gen"]) else {}
        lines.append(
            f"autoscale ({smi}, this run): step {i}: wall "
            f"{rec['perf/step_time_s']:.2f} s, bubble {rec['perf/trainer_bubble_s']:.2f} s, "
            f"tick {t_['wall_s']:.3f} s; decision "
            f"{ACTIONS[int(rec['autoscale/action'])]}/{REASONS[int(rec['autoscale/reason'])]} "
            f"suppressions {t_['last']['suppressions']} inputs "
            f"{json.dumps(t_['last']['inputs'])}; resumes "
            f"{rec['fault/suffix_resumes']:.0f}, tokens salvaged "
            f"{rec.get('fault/tokens_salvaged', 0):.0f}; stream v{g_.get('version')} "
            f"{g_.get('stream_s', float('nan')):.2f} s, dispatches A/B "
            f"{g_.get('dispatches_a')}/{g_.get('dispatches_b')}, tokens A/B "
            f"{g_.get('tokens_a')}/{g_.get('tokens_b')}, most running "
            f"{g_.get('peak_running')}; goodput {goodput_split(rec)}")
    g_ = d["greedy"]
    lines.append(
        f"autoscale ({smi}, this run): fit {d['fit_wall']:.1f} s (disagg step walls "
        f"{[round(x, 2) for x in d['disagg']]}); greedy on B against the in-process "
        f"engine: bitwise {g_['bitwise']} (logprobs {g_['logprobs_bitwise']}, first "
        f"mismatch {g_['first']}, near-tie {g_['tie']}), dense f32 "
        f"{g_['dense_err']:.4f} nats; /statusz autoscale totals "
        f"{json.dumps(d['statusz']['totals'])}; peaks trainer "
        f"{d['peaks']['trainer']:.2f} GB, A {d['peaks']['a']:.2f} GB, B "
        f"{d['peaks']['b']:.2f} GB; launches A {json.dumps(d['a_launches'])}, B "
        f"{json.dumps(d['b_launches'])}, trainer {json.dumps(d['trainer_launches'])}; "
        f"report lines {json.dumps(d['reports'])}; planes host ms "
        f"{[round(x, 2) for x in d['plane_ms']]}")
    return lines


# -- the recipe phase: the north-star llama3-8b recipe through the port -----

RECIPE_PATH = "examples/configs/stream_grpo_llama3_8b.yaml"
RECIPE_MODEL = "llama3-8b"
# llama3-8b's attention layout: 32 q heads on 8 kv heads (rep 4), no qk-norm
RECIPE_HQ, RECIPE_HKV = 32, 8
# (hidden, q heads, kv heads, intermediate, vocab): the recipe's widths
RECIPE_DIMS = (4096, 32, 8, 14336, 128256)
RECIPE_RESPONSE = 256
# the recipe's cuts (``recipe_phase``); width, vocabulary, dtype, the
# micro token budget and every switch of the reference worker's shape kept
RECIPE_OVERRIDES = [
    "device=cuda", cut_depth(REMOTE_CUT_LAYERS),
    # the reference worker's shape (tests/llama8b_e2e_worker.py)
    "rollout.colocated_local=true", "rollout.spec_tokens=2",
    # two steps of 2 prompts x rollout_n 8 (kept) = 16 sequences
    "trainer.train_batch_size=2", "trainer.ppo_mini_batch_size=16",
    "trainer.min_stream_batch_size=16", "trainer.micro_batch_size=16",
    "trainer.total_steps=2", "trainer.save_freq=0", "trainer.test_freq=0",
    f"trainer.max_response_length={RECIPE_RESPONSE}",
    # the longest prompt (max_prompt_length 1024, kept) and its response
    f"rollout.max_seq_len={1024 + RECIPE_RESPONSE}",
    "trainer.seed=0",
]
# the recipe as its YAML writes it serves without speculation (the worker's
# spec_tokens=2 is an override): one GRPO group on a prompt of more than a
# page decodes through K3 there, 8 members x rep 4 = 32 stacked rows
RECIPE_GROUP_PROMPT = 100
RECIPE_GROUP_NEW = 64


def recipe_phase(dev) -> dict:
    """The north-star recipe, ``examples/configs/stream_grpo_llama3_8b.yaml``,
    through ``load_config`` -> ``build_trainer`` -> ``fit`` (what ``python -m
    polyrl_tpu_torch.train --config ...`` runs) at llama3-8b's full width:
    hidden 4096, 32 q / 8 kv heads, head_dim 128, intermediate 14,336,
    vocab 128,256, the untied head, llama3 RoPE scaling, no qk-norm, bf16,
    random weights from seed 0. The reference worker's shape: disaggregated
    with the manager spawned and supervised by ``train``, the colocated
    local engine (``POLYRL_CB_TRACE=1`` for it), speculation (2 tokens),
    packing within the 16,384-token micro budget, optimizer offload, remat,
    chunked prefill (512), 8 fabric streams, ``parallel.fsdp=-1`` (one
    process: a mesh of one).

    Cuts, each for a reason: depth to REMOTE_CUT_LAYERS (4), since a
    full-depth push is 16 GB and offloaded AdamW 64 GB of pinned host at
    32 layers; 2 prompts a step (rollout_n 8 kept) and the mini, micro and
    stream batches to those 16 sequences, 2 steps; responses of
    RECIPE_RESPONSE tokens and ``max_seq_len`` to the longest prompt plus
    one; no checkpoint and no validation; the arithmetic dataset (no
    download), scored by ``byte_length_score`` so that a group's
    advantages are not all 0 at random weights.

    Gates: the model's dims; each step's ``actor/pg_loss`` finite; the
    local server at ``weight_version`` >= 3 (the bootstrap push and one a
    step); every step's old logprobs within LOGP_AGREE_TOL of the served
    ones; every record's goodput split (``attributed_frac`` in
    ATTRIBUTED_FRAC; the trainer times the optimizer offload, whose first
    call allocates the pinned host buffers, with the update);
    ``polyrl_engine_*`` counters on the local server's ``/metrics``. Then,
    the recipe as its YAML writes it (no speculation), the engine that
    ``train`` builds from the rollout section, on the trained weights,
    serves one GRPO group of 8 on a RECIPE_GROUP_PROMPT-token prompt:
    grouped decode through K3, which a speculating engine never runs (its
    dispatch carries no group tables, in both packages), so the recipe's
    K3 launches all come from this group. Launches counted from zero over
    the fit and that group, each apart: the fused prologue, K2, K3, K4
    forward and backward each launched, the standalone K1 never.
    Logs step walls by phase, each push's pack, wire and install, the
    peak device GB and the pinned host GB of the offloaded AdamW moments,
    and the decode step at the serving tables by replay (device ms and
    kernels by torch.profiler, apart from the counts)."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch import train
    from polyrl_tpu_torch.rollout.cb_engine import STREAM_END
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    cfg = load_config(RECIPE_PATH, RECIPE_OVERRIDES)
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    os.environ["POLYRL_CB_TRACE"] = "1"  # read once, by the local engine
    try:
        t0 = time.monotonic()
        try:
            trainer = train.build_trainer(cfg, cleanup,
                                          compute_score=byte_length_score)
        finally:
            os.environ.pop("POLYRL_CB_TRACE", None)
        build_s = time.monotonic() - t0
        actor, remote = trainer.actor, trainer.rollout
        local = remote.local_server
        eng = local.engine
        m = actor.model_cfg
        dims = (m.hidden_size, m.num_heads, m.num_kv_heads,
                m.intermediate_size, m.vocab_size)
        check(dims == RECIPE_DIMS and m.num_layers == REMOTE_CUT_LAYERS
              and m.head_dim_ == D and m.rope_scaling is not None
              and not m.use_qk_norm and not m.tie_word_embeddings,
              f"recipe: the model is {m}")
        check(eng.spec_tokens == 2 and eng._trace_enabled,
              "recipe: the local engine is not speculating and traced")
        # from the shapes: on the mesh of one the actor holds flat shards
        n_params = sum(math.prod(spec[0])
                       for _, spec in _leaves(decoder.param_specs(m)))
        # each install into the local engine (the bootstrap push and one a
        # step), timed to its end on the card
        installs: list[tuple[int, float]] = []
        update = eng.update_weights

        def timed_update(params, version=None):
            t_ = time.monotonic()
            update(params, version=version)
            torch.cuda.synchronize(dev)
            installs.append((version, time.monotonic() - t_))

        eng.update_weights = timed_update
        offloads: list[float] = []
        offload = actor.offload_opt_state

        def timed_offload():
            t_ = time.monotonic()
            offload()
            offloads.append(time.monotonic() - t_)

        actor.offload_opt_state = timed_offload
        gaps: list[float] = []
        process = trainer._process_ibatch

        def gap_gate(ibatch, metrics):
            out = process(ibatch, metrics)
            mask = np.asarray(out["response_mask"]) > 0
            gaps.append(float(np.abs(
                np.asarray(out["old_log_probs"])
                - np.asarray(out["rollout_log_probs"]))[mask].max()))
            return out

        trainer._process_ibatch = gap_gate
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        fit_launches = dict(cuda_build.LAUNCHES)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        pinned_gb = sum(h.numel() * h.element_size()
                        for h in actor._opt_host or []) / 1e9
        check(len(history) == 2, "recipe: the fit did not run 2 steps")
        for i, rec in enumerate(history, 1):
            check(np.isfinite(rec.get("actor/pg_loss", float("nan"))),
                  f"recipe step {i}: actor/pg_loss missing or not finite")
        plane_gates(history, "recipe")
        t_v = time.monotonic()
        while eng.weight_version < 3 and time.monotonic() - t_v < 60:
            time.sleep(0.1)
        check(eng.weight_version >= 3, f"recipe: the local server at "
              f"v{eng.weight_version} after 2 steps, not >= 3")
        check(gaps and max(gaps) <= LOGP_AGREE_TOL,
              f"recipe: old logprobs vs the served ones, max by batch "
              f"{gaps} nats (> {LOGP_AGREE_TOL})")
        check(pinned_gb > 0, "recipe: no AdamW moments on the host")
        metrics = get_text(local.port, "/metrics")
        engine_lines = [ln_ for ln_ in metrics.splitlines()
                        if ln_.startswith("polyrl_engine_")]
        check(any(ln_.startswith("polyrl_engine_n_spec_dispatch ")
                  for ln_ in engine_lines)
              and any(ln_.startswith("polyrl_engine_n_fetch ")
                      for ln_ in engine_lines),
              f"recipe: /metrics lacks the engine counters: {engine_lines}")

        # the recipe as its YAML writes it: no speculation, grouped decode,
        # on the engine ``train`` builds from the rollout section
        plain_cfg = dataclasses.replace(cfg.rollout, spec_tokens=0)
        t_g = time.monotonic()
        geng = train._cb_engine(dataclasses.replace(cfg, rollout=plain_cfg),
                                m, actor.export_params(), trainer.tokenizer,
                                dev)
        rng = np.random.default_rng(5)
        prompt = rng.integers(1, m.vocab_size, RECIPE_GROUP_PROMPT).tolist()
        sp = SamplingParams(temperature=1.0, max_new_tokens=RECIPE_GROUP_NEW,
                            stop_token_ids=())
        qs = [geng.submit(f"rg{i}", prompt, sp, group_id="rg", group_size=8)
              for i in range(8)]
        geng.start()
        try:
            group = []
            for q in qs:
                toks, lps = [], []
                while (item := q.get(timeout=300)) is not STREAM_END:
                    toks += item["token_ids"]
                    lps += item["logprobs"]
                group.append((toks, lps))
        finally:
            geng.stop()
        group_s = time.monotonic() - t_g
        check(all(len(t_) == RECIPE_GROUP_NEW and np.isfinite(l_).all()
                  and max(l_) <= 0 for t_, l_ in group),
              f"recipe: the group's lengths {[len(t_) for t_, _ in group]}")
        check(geng.grouped_decode_dispatches > 0,
              "recipe: the group did not decode grouped")
        grouped = geng.grouped_decode_dispatches
        del geng
        launches = dict(cuda_build.LAUNCHES)
        for name in SERVE_KERNELS + K4_NAMES:
            check(launches[name] > 0, f"recipe: {name} was not launched")
        check(launches["paged_kv_write"] == 0,
              "recipe: the standalone K1 was launched on the fused route")
        gc.collect()
        torch.cuda.empty_cache()
        with launches_apart({}):
            step = decode_step_replay(dev, actor.export_params(), m)
        iface = remote.transfer
        rounds = {r_["version"]: r_ for r_ in iface.sender.round_log}
        inst = dict(installs)
        pushes = [dict(version=pl["version"], pack_s=pl["pack_s"],
                       wire_s=rounds.get(pl["version"], {}).get("push_s"),
                       install_s=inst.get(pl["version"]))
                  for pl in iface.push_log]
        return dict(history=history, build_s=build_s, fit_wall=fit_wall,
                    n_params=n_params, peak_gb=peak_gb, pinned_gb=pinned_gb,
                    gaps=gaps, pushes=pushes, launches=launches, step=step,
                    fit_launches=fit_launches,
                    offloads=offloads,
                    engine_lines=engine_lines, group_s=group_s,
                    grouped=grouped, version=eng.weight_version,
                    trace=eng.trace_report())
    finally:
        for fn in reversed(cleanup):
            fn()


def recipe_lines(r: dict, rows: list[dict], smi: str) -> list[str]:
    tag = (f"recipe ({smi}, this run, {REMOTE_CUT_LAYERS} of "
           f"{RECIPE_MODEL}'s 32 layers)")
    st = r["step"]
    lines = [f"{tag}: kernels at Hq {RECIPE_HQ}, Hkv {RECIPE_HKV}, D {D} (rep "
             f"{RECIPE_HQ // RECIPE_HKV}, null norms): " + "; ".join(
                 f"{x['name']} max_abs_err {x['max_abs_err']:.3g} ms "
                 f"{x['ms']:.4f} plain_ms {x['plain_ms']:.4f} bound_ms "
                 f"{x['bound_ms']:.4f} ({x['bound_by']}) library_ms "
                 + ("None" if x["library_ms"] is None
                    else f"{x['library_ms']:.4f}") for x in rows)]
    lines.append(
        f"{tag}: {RECIPE_PATH} at full width ({r['n_params'] / 1e9:.3f} B "
        f"parameters, bf16, seed 0): trainer up in {r['build_s']:.1f} s, fit "
        f"{r['fit_wall']:.1f} s; local server at v{r['version']}; old "
        f"logprobs vs served, max by batch {[round(g, 4) for g in r['gaps']]} "
        f"nats (limit {LOGP_AGREE_TOL}); peak {r['peak_gb']:.2f} GB on the "
        f"card, AdamW moments {r['pinned_gb']:.2f} GB pinned on the host "
        f"(each step's offload call, host s, timed with update_actor: "
        f"{[round(x, 3) for x in r['offloads']]}; the first allocates the "
        f"pinned buffers)")
    for i, (rec, w) in enumerate(zip(r["history"], _step_walls(r["history"])),
                                 1):
        lines.append(
            f"{tag}: step {i} {w['step']:.2f} s (" + ", ".join(
                f"{k_} {v:.2f}" for k_, v in w.items() if k_ != "step")
            + f"); pg_loss {rec['actor/pg_loss']:.5f}; goodput "
            + goodput_split(rec))
    lines.append(f"{tag}: pushes (pack / wire / install s; no remote "
                 f"receiver, the wire unused): " + "; ".join(
                     f"v{p_['version']} {p_['pack_s']:.3f} / "
                     + ("none" if p_["wire_s"] is None else f"{p_['wire_s']:.3f}")
                     + " / " + ("none" if p_["install_s"] is None
                                else f"{p_['install_s']:.3f}")
                     for p_ in r["pushes"]))
    fit = r["fit_launches"]
    lines.append(
        f"{tag}: launches of the fit "
        + json.dumps(fit) + ", of the group without speculation "
        + json.dumps({k_: r["launches"][k_] - fit[k_] for k_ in fit})
        + f" (the recipe's K3 launches in the kernels line are the group's); "
        f"the group: {r['grouped']} grouped decode "
        f"dispatches in {r['group_s']:.1f} s; engine trace "
        + json.dumps({k_: round(v, 4) for k_, v in sorted(r["trace"].items())}))
    lines.append(
        f"{tag}: decode step by replay (serving tables, 18 live of 64, K2): "
        f"wall ms {st['wall_ms']:.2f}, device ms {st['device_ms']:.3f}, "
        f"kernels {st['kernels']:.1f}; weight floor {st['floor_ms']:.2f} ms "
        f"({st['read_gb']:.2f} GB read a step at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s)")
    return lines


# -- phase 16: the MoE family (qwen3-30b-a3b) ------------------------------------

MOE_MODEL = "qwen3-30b-a3b"
MOE_HQ, MOE_HKV = 32, 4        # its attention: 32 q heads on 4 kv heads (rep 8)
# depths: serving at the preset's 48 layers (61.1 GB of bf16 weights, with
# the 512-page pool and the decode graphs' buffers); the fit at 4 layers
# (3.1 B parameters, held by the actor, its AdamW moments, the reference
# copy and the engine); the f32 gate, the checkpoint and int8 at 2
MOE_SERVE_LAYERS = 48
MOE_TRAIN_LAYERS = 4
MOE_SMALL_LAYERS = 2
# E / k: no dispatch ever drops a choice, so a token's output does not
# depend on the batch it was served in; every logprob gate runs here, the
# throughput mix at the preset's 2.0
MOE_DROPLESS = 16.0
MOE_ENGINE = dict(max_slots=S, page_size=PS, max_seq_len=4096, num_pages=512,
                  steps_per_dispatch=8, seed=0)
MOE_NEW = 64
# served bf16 logprobs against the bf16 forward with a cache (48 layers,
# teacher-forced on the served tokens) and against the dense f32 forward
# (2 layers), in nats: the router's logits are a bf16 product, as in the
# reference, and one bf16 rounding more or less swaps a near-tied k-th
# expert (at 128 experts the k-th and the next sit within a bf16 ulp for
# about one token-layer in seven), which moves that token's output by the
# two experts' difference times their weight; the dense serve gate's 0.15,
# scaled by the depth (48 layers against 28)
MOE_LOGP_TOL = 0.25
# the same weights served in f32 (f32 pools, the kernels' f32 instances)
# against the dense f32 forward, in nats: reduction order only (the f32
# kernels sit within 2e-5 of their plain versions, the card tests)
MOE_F32_TOL = 1e-3


@contextlib.contextmanager
def head_layout(hq: int, hkv: int, model: str):
    """The kernel checks' head layout and preset (``HQ``, ``HKV``,
    ``MODEL``) for the block."""
    global HQ, HKV, MODEL
    saved = HQ, HKV, MODEL
    HQ, HKV, MODEL = hq, hkv, model
    try:
        yield
    finally:
        HQ, HKV, MODEL = saved


def layout_kernels(dev, hq: int, hkv: int, model: str, label: str
                   ) -> list[dict]:
    """K1, the fused prologue, K2, K3 (the kernel case: 64 slots of 1-4096
    tokens and groups of 8, G * rep stacked rows) and K4 forward and
    backward (B 4, T 512) against their plain versions under the kernels
    phase's bounds, at ``model``'s attention layout (``hq`` q heads on
    ``hkv`` kv heads; its norms, null where it has no qk-norm)."""
    with head_layout(hq, hkv, model):
        rows = check_kernels(dev) + list(flash_case_check(
            dev, 4, 512, 7, f"{label} layout, train phase shapes", reps=10,
            repeat=True))
    torch.cuda.empty_cache()
    return rows


def decode_step_replay(dev, params, cfg) -> dict:
    """One decode step (``forward_paged_decode``, the fused route) at the
    serving tables, captured in a CUDA graph and replayed: wall ms (host
    clock around a synchronised replay, median of 20), device ms and
    kernels a step (torch.profiler over 5 replays), and the weight floor:
    every weight the step reads (all but the embedding, a gather; the
    reference's dispatch multiplies every expert in every step) over the
    card's memory rate."""
    from polyrl_tpu_torch.models import quant

    table, lens, _ = serving_tables(dev)
    active = lens > 0
    pools = decoder.make_paged_pools(cfg, int(table.max()) + 1, PS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(4)
    for p_ in pools[0] + pools[1]:
        p_.normal_(generator=gen)
    tokens = torch.randint(1, cfg.vocab_size, (S,), generator=gen, device=dev)

    def step():
        return decoder.forward_paged_decode(params, cfg, tokens, lens, pools,
                                            table, lens, active=active)[0]

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        step()
    graph.replay()
    torch.cuda.synchronize()
    walls = []
    for _ in range(20):
        t0 = time.monotonic()
        graph.replay()
        torch.cuda.synchronize()
        walls.append((time.monotonic() - t0) * 1e3)
    prof = device_profile(graph.replay, 5)
    read = quant.weight_bytes(params) - quant.weight_bytes(params["embed"])
    del graph
    return dict(wall_ms=statistics.median(walls), device_ms=prof["device_ms"],
                kernels=prof["kernels"], floor_ms=read / HBM_BYTES_PER_S * 1e3,
                read_gb=read / 1e9)


def cache_forward_rows(params, cfg, prompt, tokens, dev) -> torch.Tensor:
    """The bf16 forward with a cache (the prefill path: dense attention,
    one chunk) over ``prompt`` + ``tokens``, log-softmax in f32: row ``j``
    predicts ``tokens[j]``."""
    x = torch.tensor([list(prompt) + list(tokens)], device=dev)
    t = x.shape[1]
    pos = torch.arange(t, device=dev, dtype=torch.int32)[None]
    cache = decoder.make_cache(cfg, 1, t, device=dev)
    logits, _ = decoder.forward(params, cfg, x, pos,
                                torch.ones((1, t), device=dev), cache=cache)
    return torch.log_softmax(logits[0, len(prompt) - 1:-1].float(), dim=-1)


def moe_engine_streams(eng, reqs: list[tuple]) -> list[dict]:
    """``reqs`` of (rid, prompt, sampling, group id, group size) submitted
    to a started engine and read to their ends: tokens and logprobs."""
    qs = [eng.submit(rid, p, sp, group_id=gid, group_size=gs)
          for rid, p, sp, gid, gs in reqs]
    eng.start()
    outs = []
    for q in qs:
        lines = [ln for _, ln in stream_items(q)]
        outs.append(dict(tokens=[t for ln in lines for t in ln["token_ids"]],
                         logprobs=[x for ln in lines for x in ln["logprobs"]]))
    return outs


def moe_dropless_gates(dev, params, cfg, prompts: list) -> dict:
    """At ``MOE_DROPLESS``: (1) greedy streams served by a ``CBEngine`` on
    the served weights, teacher-forced through the bf16 forward with a
    cache: logprobs within MOE_LOGP_TOL, greedy tokens the forward's argmax
    until its first top-2 near-tie (``agrees_until_tie``); (2) on an
    engine driven through its internals, an all-greedy batch (two GRPO
    groups of 8 and two lone requests, mid-decode) dispatched by graph
    replay and by the eager body from one snapshot, for an ungrouped key
    (K2) and a grouped one (K3): the same tokens."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    greedy = SamplingParams(temperature=0.0, max_new_tokens=MOE_NEW)
    eng = CBEngine(cfg, params, device=dev, copy_params=False, **MOE_ENGINE)
    try:
        outs = moe_engine_streams(eng, [(f"tf{i}", p, greedy, "", 0)
                                        for i, p in enumerate(prompts)])
    finally:
        eng.stop()
    del eng
    forced = []
    for p, o in zip(prompts, outs):
        check(len(o["tokens"]) == MOE_NEW, f"moe: {len(o['tokens'])} tokens served")
        lsm = cache_forward_rows(params, cfg, p, o["tokens"], dev)
        gen = torch.tensor(o["tokens"], device=dev)
        diff = (lsm.gather(-1, gen[:, None])[:, 0]
                - torch.tensor(o["logprobs"], device=dev)).abs()
        err = diff.max().item()
        top2 = lsm.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        ok, first, tie, gap = agrees_until_tie(
            o["tokens"], lsm.argmax(-1).tolist(), gaps)
        forced.append(dict(err=err, first=first, tie=tie, gap=gap,
                           over=int((diff > MOE_LOGP_TOL).sum()),
                           median=diff.median().item()))
        check(err <= MOE_LOGP_TOL and ok,
              f"moe: served against the cached forward: max |logprob diff| "
              f"{err:.4f} (limit {MOE_LOGP_TOL}); greedy agreement {ok} "
              f"(first mismatch {first}, first near-tie {tie}, gap {gap:.4f})")
        del lsm

    eng = CBEngine(cfg, params, device=dev, copy_params=False, **MOE_ENGINE)
    rng = np.random.default_rng(5)
    sp = SamplingParams(temperature=0.0, max_new_tokens=MOE_NEW)
    for g, n_p in enumerate((200, 203)):
        prompt = rng.integers(1, cfg.vocab_size, n_p).tolist()
        for i in range(8):
            eng.submit(f"g{g}-{i}", prompt, sp, group_id=f"grp{g}", group_size=8)
    for i, n_p in enumerate((198, 205)):
        eng.submit(f"greedy{i}", rng.integers(1, cfg.vocab_size, n_p).tolist(), sp)
    eng._drain_queue()
    with eng._pool_lock:
        eng._admit()
        eng._step_once()
        eng._drain_emit_q()
    tables = eng._decode_group_pack()
    check(tables is not None and int(eng._active.sum()) == 18,
          f"moe: {int(eng._active.sum())} active slots, groups {tables is not None}")
    replay = {}
    for label, tb in (("ungrouped (K2)", None), ("grouped (K3)", tables)):
        run = graph_against_eager(eng, False, tb)
        same_tok = torch.equal(run["graph"][0], run["eager"][0])
        lp = (run["graph"][1] - run["eager"][1]).abs().max().item()
        bitwise = (all(torch.equal(a, b) for a, b in zip(run["graph"], run["eager"]))
                   and states_equal(run["graph_state"], run["eager_state"]))
        check(same_tok, f"moe: {label}: the replayed dispatch's greedy tokens "
              f"differ from the eager body's")
        replay[label] = dict(lp=lp, bitwise=bitwise)
        del run
    eng.stop()
    del eng
    return dict(forced=forced, replay=replay)


def moe_serve(dev) -> dict:
    """``create_server`` of qwen3-30b-a3b at full width and MOE_SERVE_LAYERS
    (bf16, seed 0, the preset's capacity factor 2.0): the serve phase's
    18-stream mix over HTTP, then one greedy request alone (launches from
    zero: the fused prologue, K2, K3); the decode step by replay; then the
    dropless gates on the same weights."""
    from polyrl_tpu_torch.rollout.serve import create_server

    t0 = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    server = create_server(MOE_MODEL, device=str(dev), host="127.0.0.1", port=0,
                           model_overrides={"num_layers": MOE_SERVE_LAYERS},
                           **MOE_ENGINE)
    up_s = time.monotonic() - t0
    cfg, params = server.engine.cfg, server.engine.params
    try:
        port = server.port
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)
        run_requests(port, [{"rid": "warmup", "input_ids": warm,
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})
        info0 = post(port, "/get_server_info", None)
        cuda_build.reset_launch_counts()
        outs = run_requests(port, bodies)
        info = post(port, "/get_server_info", None)
        post(port, "/flush_cache", {})
        lone = run_requests(port, [{
            "rid": "lone", "input_ids": greedy_prompts[0],
            "sampling_params": {"temperature": 0.0, "max_new_tokens": MOE_NEW}}])
        launches = dict(cuda_build.LAUNCHES)
        for name in SERVE_KERNELS:
            check(launches[name] > 0, f"moe: {name} was not launched serving "
                  f"{MOE_MODEL}")
        check(launches["paged_kv_write"] == 0,
              "moe: the serving path took the unfused K/V write")
        for o in outs + lone:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0,
                  "moe: non-finite or positive logprob")
            check(all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                  "moe: token outside the vocabulary")
        tok_s = mix_tok_s(outs)
        ttft = statistics.median(o["lines"][0][0] - o["t0"] for o in outs)
        dispatches = dispatch_line(info0, info)
        serve_peak = torch.cuda.max_memory_allocated(dev) / 1e9
    finally:
        server.stop()
    del server
    gc.collect()
    torch.cuda.empty_cache()
    step = decode_step_replay(dev, params, cfg)
    gates = moe_dropless_gates(
        dev, params, dataclasses.replace(cfg, moe_capacity_factor=MOE_DROPLESS),
        greedy_prompts)
    n_params = sum(t.numel() for _, t in _leaves(params))
    del params
    return dict(launches=launches, tok_s=tok_s, ttft=ttft, up_s=up_s,
                dispatches=dispatches, step=step, gates=gates,
                n_params=n_params, peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                serve_peak_gb=serve_peak)


def moe_small(dev) -> dict:
    """qwen3-30b-a3b at full width and MOE_SMALL_LAYERS layers (seed 0,
    dropless): greedy streams served by a ``CBEngine`` against the dense
    f32 forward, within MOE_F32_TOL served in f32 and within MOE_LOGP_TOL
    served in bf16; the tree written as a
    Qwen3-MoE checkpoint (two bf16 shards) and loaded back bitwise, and
    with ``quantize="int8"`` bitwise ``quantize_params`` of that load
    (the router in bf16); the int8 tree served greedy (a GRPO group of 8,
    then a lone request: the fused prologue, K2 and K3 launched, counted
    from zero); the decode step by replay in bf16 and in int8."""
    from polyrl_tpu_torch.models import hf_loader, quant
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    cfg = decoder.get_config(MOE_MODEL, num_layers=MOE_SMALL_LAYERS,
                             moe_capacity_factor=MOE_DROPLESS)
    params = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    _, prompts, _ = serving_mix(cfg.vocab_size)
    greedy = SamplingParams(temperature=0.0, max_new_tokens=MOE_NEW)
    params32 = f32_copy(params)
    cfg32 = dataclasses.replace(cfg, dtype=torch.float32)
    dense = {}
    for label, c_, p_, kv in (("bf16", cfg, params, None),
                              ("f32", cfg32, params32, torch.float32)):
        eng = CBEngine(c_, p_, device=dev, copy_params=False,
                       kv_cache_dtype=kv, **MOE_ENGINE)
        try:
            outs = moe_engine_streams(eng, [(f"{label}-{i}", p, greedy, "", 0)
                                            for i, p in enumerate(prompts)])
        finally:
            eng.stop()
        del eng
        rows = []
        for p, o in zip(prompts, outs):
            lsm = dense_f32_rows(params32, cfg32, p, o["tokens"], dev)
            gen = torch.tensor(o["tokens"], device=dev)
            ref = lsm.gather(-1, gen[:, None])[:, 0]
            diff = (ref - torch.tensor(o["logprobs"], device=dev)).abs()
            rows.append(dict(err=diff.max().item(), median=diff.median().item(),
                             gap=(lsm.max(dim=-1).values - ref).max().item(),
                             over=int((diff > DENSE_LOGP_TOL).sum())))
        dense[label] = rows
    del params32
    for label, limit in (("f32", MOE_F32_TOL), ("bf16", MOE_LOGP_TOL)):
        worst = max(max(r["err"], r["gap"]) for r in dense[label])
        check(worst <= limit, f"moe: served {label} at {MOE_SMALL_LAYERS} layers "
              f"against the dense f32 forward: {dense[label]} (limit {limit})")

    tmp = tempfile.mkdtemp(prefix="moe-hf-")
    try:
        t0 = time.monotonic()
        n_bytes = hf_loader.save_hf_checkpoint(tmp, params, cfg,
                                               model_type="qwen3_moe", n_shards=2)
        write_s = time.monotonic() - t0
        t0 = time.monotonic()
        cfg_b, back = hf_loader.build_from_hf(tmp, dtype=cfg.dtype, device=dev)
        torch.cuda.synchronize()
        load_s = time.monotonic() - t0
        check(dataclasses.replace(cfg_b, moe_capacity_factor=MOE_DROPLESS) == cfg,
              f"moe: the checkpoint's config {cfg_b} != {cfg}")
        want = dict(_leaves(params))
        got = dict(quant.named_leaves(back))
        check(got.keys() == want.keys()
              and all(torch.equal(got[k], want[k]) for k in want),
              "moe: the checkpoint does not load back bitwise")
        t0 = time.monotonic()
        _, q8 = hf_loader.build_from_hf(tmp, dtype=cfg.dtype, quantize="int8",
                                        device=dev)
        torch.cuda.synchronize()
        int8_s = time.monotonic() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ref = dict(quant.named_leaves(quant.quantize_params(back)))
    got = dict(quant.named_leaves(q8))
    check(got.keys() == ref.keys()
          and all(torch.equal(got[k], ref[k]) for k in ref)
          and not isinstance(q8["layers"]["router"], quant.QuantWeight)
          and q8["layers"]["router"].dtype == cfg.dtype
          and isinstance(q8["layers"]["we_gate"], quant.QuantWeight),
          "moe: the int8 load is not quantize_params of the bf16 load")
    del back, ref, got, want
    int8_gb = quant.weight_bytes(q8) / 1e9

    eng = CBEngine(cfg, q8, device=dev, **MOE_ENGINE)
    try:
        cuda_build.reset_launch_counts()
        group = moe_engine_streams(eng, [(f"q{i}", prompts[0], greedy, "qg", 8)
                                         for i in range(8)])
        lone = moe_engine_streams(eng, [("q-lone", prompts[1], greedy, "", 0)])
        launches = dict(cuda_build.LAUNCHES)
    finally:
        eng.stop()
    del eng
    for name in SERVE_KERNELS:
        check(launches[name] > 0, f"moe: {name} was not launched serving int8")
    check(all(o["tokens"] == group[0]["tokens"] for o in group)
          and len(lone[0]["tokens"]) == MOE_NEW,
          "moe: the int8 greedy group's members differ")
    steps = {"bf16": decode_step_replay(dev, params, cfg),
             "int8": decode_step_replay(dev, q8, cfg)}
    del q8, params
    return dict(dense=dense, write_s=write_s, load_s=load_s, int8_s=int8_s,
                ckpt_gb=n_bytes / 1e9, int8_gb=int8_gb, launches=launches,
                steps=steps)


def moe_train(dev) -> dict:
    """``build_trainer`` on the train phase's configuration with
    qwen3-30b-a3b at full width and MOE_TRAIN_LAYERS layers, dropless: 2
    GRPO steps (KL loss, remat). Gates: finite losses, grad norms > 0, no
    skipped update, K4 forward and backward and the decode kernels
    launched (from zero), step 1's old logprobs (K4) within
    LOGP_AGREE_TOL of the engine's, the router and every expert leaf moved
    from the reference copy."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    over = [o for o in TRAIN_OVERRIDES if not o.startswith("model.preset=")]
    over += [f"model.preset={MOE_MODEL}", "model.overrides=" + json.dumps(
        {"num_layers": MOE_TRAIN_LAYERS, "moe_capacity_factor": MOE_DROPLESS})]
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    trainer = build_trainer(load_config(None, over), cleanup,
                            compute_score=byte_length_score)
    try:
        actor = trainer.actor
        up_gb = torch.cuda.memory_allocated(dev) / 1e9
        gaps: dict = {}
        process = trainer._process_ibatch

        def step1_gap(ibatch, metrics):
            out = process(ibatch, metrics)
            if not gaps:
                mask = np.asarray(out["response_mask"]) > 0
                gap = np.abs(np.asarray(out["old_log_probs"])
                             - np.asarray(out["rollout_log_probs"]))[mask]
                gaps.update(max=float(gap.max()), mean=float(gap.mean()),
                            tokens=int(mask.sum()))
            return out

        trainer._process_ibatch = step1_gap
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        launches = dict(cuda_build.LAUNCHES)
        trainer._process_ibatch = process
        check(len(history) == 2, "moe: the fit did not run 2 steps")
        for i, rec in enumerate(history, 1):
            for key in ("actor/pg_loss", "actor/kl_loss", "actor/grad_norm"):
                check(np.isfinite(rec.get(key, np.nan)),
                      f"moe: step {i}: {key} missing or not finite")
            check(rec["actor/grad_norm"] > 0 and rec["actor/nonfinite_skips"] == 0,
                  f"moe: step {i}: zero gradient or a skipped update")
        for name in TRAIN_KERNELS:
            check(launches[name] > 0, f"moe: {name} was not launched in the fit")
        check(gaps["max"] <= LOGP_AGREE_TOL,
              f"moe: old logprobs disagree with the engine's ({gaps['max']:.4f} "
              f"nats > {LOGP_AGREE_TOL})")
        ref = trainer.ref_policy.params["layers"]
        moved = {}
        for key in ("router", "we_gate", "we_up", "we_down"):
            a, r = actor.params["layers"][key].detach(), ref[key]
            moved[key] = float((a != r).float().mean())
            check(moved[key] > 0, f"moe: {key} did not move")
        walls = [{k_: rec.get("timing_s/" + k_, 0.0) for k_ in (
            "gen", "old_log_prob", "ref_log_prob", "update_actor",
            "update_weight")} | {"step": rec["perf/step_time_s"]}
            for rec in history]
        n_params = sum(p.numel() for _, p in _leaves(actor.params))
        return dict(launches=launches, gaps=gaps, moved=moved, walls=walls,
                    fit_s=fit_s, up_gb=up_gb, n_params=n_params,
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    grad_norms=[rec["actor/grad_norm"] for rec in history])
    finally:
        for fn in reversed(cleanup):
            fn()


def moe_phase(dev) -> dict:
    """The MoE phase: kernels at the MoE layout, serving at full depth,
    the small-depth gates, the fit. Returns its readings and the launches
    of its main paths (the HTTP mix and lone request, the int8 engine's
    streams, the fit)."""
    t0 = time.monotonic()
    rows = layout_kernels(dev, MOE_HQ, MOE_HKV, MOE_MODEL, "moe")
    served = moe_serve(dev)
    gc.collect()
    torch.cuda.empty_cache()
    small = moe_small(dev)
    gc.collect()
    torch.cuda.empty_cache()
    trained = moe_train(dev)
    gc.collect()
    torch.cuda.empty_cache()
    launches = {k_: served["launches"][k_] + small["launches"][k_]
                + trained["launches"][k_] for k_ in cuda_build.LAUNCHES}
    return dict(rows=rows, served=served, small=small, trained=trained,
                launches=launches, seconds=time.monotonic() - t0)


def moe_lines(m: dict, smi: str) -> list[str]:
    tag = f"moe ({smi}, this run)"
    sv, sm, tr = m["served"], m["small"], m["trained"]
    lines = [f"{tag}: kernels at Hq {MOE_HQ}, Hkv {MOE_HKV}, D {D} (rep "
             f"{MOE_HQ // MOE_HKV}): " + "; ".join(
                 f"{r['name']} max_abs_err {r['max_abs_err']:.3g} ms "
                 f"{r['ms']:.4f} plain_ms {r['plain_ms']:.4f} bound_ms "
                 f"{r['bound_ms']:.4f} ({r['bound_by']}) library_ms "
                 + ("None" if r["library_ms"] is None else f"{r['library_ms']:.4f}")
                 for r in m["rows"])]
    st = sv["step"]
    lines.append(
        f"{tag}: serve {MOE_MODEL} at {MOE_SERVE_LAYERS} layers, full width "
        f"({sv['n_params'] / 1e9:.2f} B parameters, bf16, seed 0, factor 2.0), "
        f"up in {sv['up_s']:.1f} s: the 18-stream mix {sv['tok_s']:.1f} decode "
        f"tok/s, TTFT median {sv['ttft'] * 1e3:.1f} ms; {sv['dispatches']}; "
        f"main-path launches " + json.dumps(
            {k_: sv["launches"][k_] for k_ in SERVE_KERNELS})
        + f"; decode step by replay (serving tables, 18 live of 64): wall ms "
        f"{st['wall_ms']:.2f}, device ms {st['device_ms']:.3f}, kernels "
        f"{st['kernels']:.1f}; weight floor {st['floor_ms']:.2f} ms "
        f"({st['read_gb']:.2f} GB read a step at {HBM_BYTES_PER_S / 1e12:.2f} "
        f"TB/s); peak {sv['serve_peak_gb']:.2f} GB serving, {sv['peak_gb']:.2f} "
        f"GB with the gates")
    g = sv["gates"]
    lines.append(
        f"{tag}: dropless (factor {MOE_DROPLESS}) at {MOE_SERVE_LAYERS} layers: "
        f"served greedy against the bf16 forward with a cache: "
        + "; ".join(f"max |logprob diff| {f['err']:.4f} (first mismatch "
                    f"{f['first']}, first near-tie {f['tie']})" for f in g["forced"])
        + f" (limit {MOE_LOGP_TOL}); graph replay against the eager body: "
        + "; ".join(f"{k_} tokens equal, logprobs max diff {v['lp']:.3g}, "
                    f"bitwise {v['bitwise']}" for k_, v in g["replay"].items()))
    bf, i8 = sm["steps"]["bf16"], sm["steps"]["int8"]
    lines.append(
        f"{tag}: at {MOE_SMALL_LAYERS} layers, full width, greedy served against "
        f"dense f32 (max |logprob diff|, median, chosen-token gap, positions "
        f"over {DENSE_LOGP_TOL}): " + "; ".join(
            f"served {lb} " + ", ".join(
                f"({r['err']:.4g}, {r['median']:.4g}, {r['gap']:.4g}, {r['over']})"
                for r in rows) for lb, rows in sm["dense"].items())
        + f" (limits f32 {MOE_F32_TOL}, bf16 {MOE_LOGP_TOL}); "
        f"checkpoint {sm['ckpt_gb']:.2f} GB written in {sm['write_s']:.1f} s, "
        f"loaded bf16 in {sm['load_s']:.1f} s (bitwise), int8 in "
        f"{sm['int8_s']:.1f} s ({sm['int8_gb']:.2f} GB; bitwise quantize_params "
        f"of the bf16 load, router bf16); int8 greedy group and lone request "
        f"launches " + json.dumps({k_: sm["launches"][k_] for k_ in SERVE_KERNELS})
        + f"; decode step by replay bf16 / int8: device ms {bf['device_ms']:.3f} "
        f"/ {i8['device_ms']:.3f}, wall ms {bf['wall_ms']:.2f} / "
        f"{i8['wall_ms']:.2f}, kernels {bf['kernels']:.1f} / {i8['kernels']:.1f}")
    lines.append(
        f"{tag}: fit at {MOE_TRAIN_LAYERS} layers, full width "
        f"({tr['n_params'] / 1e9:.2f} B parameters, dropless), 2 GRPO steps: "
        f"fit {tr['fit_s']:.1f} s; step walls by phase "
        + json.dumps([{k_: round(v, 2) for k_, v in w.items()} for w in tr["walls"]])
        + f"; step-1 old logprobs vs the engine's over {tr['gaps']['tokens']} "
        f"tokens: max {tr['gaps']['max']:.4f}, mean {tr['gaps']['mean']:.5f} "
        f"nats (limit {LOGP_AGREE_TOL}); moved from the reference copy "
        + json.dumps({k_: round(v, 4) for k_, v in tr["moved"].items()})
        + f"; grad norms {[round(x, 4) for x in tr['grad_norms']]}; launches "
        + json.dumps({k_: tr["launches"][k_] for k_ in TRAIN_KERNELS})
        + f"; {tr['up_gb']:.2f} GB after the build, peak {tr['peak_gb']:.2f} GB")
    return lines


# -- tp: one process's tensor-parallel shards serving ----------------------------

TP = 2
TP_PAGES = 512            # 3.76 GB of KV over both shards (the phase's own)
TP_F32_LAYERS = 2
TP_F32_NEW = 32
# the served tp=2 engine's greedy logprobs against the tp=1 engine's on
# the same bf16 weights, in nats, over the tokens before the first
# mismatch: the shards' row-parallel partials add in f32 and round once,
# so the two differ by the order of f32 sums and by K2/K3's page chunks
# (chosen from Hkv, which halves), each a bf16 ulp here and there through
# 28 layers; the serve gate's limit
TP_LOGP_TOL = DENSE_LOGP_TOL
# the decode step on 2 shards and on 1 from the same pools and inputs, each
# against the same step in f32 (f32 weights and pools, one shard): max
# |log-softmax diff| over the live slots' vocabulary. Both bf16 steps sit
# away from f32 by their roundings through 28 layers; the shards add the
# one-ulp sources above, so 2 shards may sit at most this many times as
# far as 1 (a lost partial or a wrong head split lands whole nats away)
TP_STEP_RATIO = 1.5
# serve --tp 2 on qwen3-30b-a3b: full width at this depth, dropless (E / k),
# so that a token's experts do not depend on the batch it is served in;
# its decode step's distance from f32 is held to TP_STEP_RATIO x one
# shard's or MOE_LOGP_TOL, whichever is larger: a near-tied k-th expert
# that one more bf16 rounding swaps moves a token by a tenth of a nat
TP_MOE_LAYERS = 2
TP_MOE_OVERRIDES = {"num_layers": TP_MOE_LAYERS,
                    "moe_capacity_factor": MOE_DROPLESS}


def tp_step_pools(cfg, dev, n_pages: int, tp: int, seed: int = 4):
    """Random bf16 pools for the decode step at the serving tables: one
    shard's ``(k, v)`` lists, and the same K/V cut into ``tp`` shards of
    ``Hkv/tp`` heads (each pool its own allocation)."""
    pools = decoder.make_paged_pools(cfg, n_pages, PS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for p_ in pools[0] + pools[1]:
        p_.normal_(generator=gen)
    shards = [([p_.chunk(tp, 0)[s_].clone() for p_ in pools[0]],
               [p_.chunk(tp, 0)[s_].clone() for p_ in pools[1]])
              for s_ in range(tp)]
    return pools, shards


def tp_decode_step(dev, params, cfg, floor: float = 0.0) -> dict:
    """The decode step at the serving tables (64 slots, 18 live) on one
    shard and on TP shards of the same weights and K/V: one eager step of
    each from the same inputs (log-softmax gap over the live slots), then
    each captured in a CUDA graph and replayed: the replay bitwise the
    eager step, AB_STEPS replays' walls and launches, PROF_STEPS traced
    for device ms and kernels per step."""
    table, lens, _ = serving_tables(dev)
    active = lens > 0
    one, shard_pools = tp_step_pools(cfg, dev, int(table.max()) + 1, TP)
    gen = torch.Generator(device=dev).manual_seed(5)
    tokens = torch.randint(1, cfg.vocab_size, (S,), generator=gen, device=dev)
    # the f32 anchor: one shard, f32 weights and a f32 copy of the pools
    params32 = f32_copy(params)
    pools32 = ([p_.float() for p_ in one[0]], [p_.float() for p_ in one[1]])
    lsm32 = torch.log_softmax(decoder.forward_paged_decode(
        params32, cfg, tokens, lens, pools32, table, lens,
        active=active)[0][active].float(), dim=-1)
    del params32, pools32
    shards = decoder.shard_tp(params, TP, [dev] * TP)
    runs = {1: (params, one), TP: (shards, shard_pools)}
    out = {}
    lsm = {}
    for tp, (w, pools) in runs.items():
        def step(w=w, pools=pools):
            return decoder.forward_paged_decode(w, cfg, tokens, lens, pools,
                                                table, lens, active=active)[0]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            eager = step().clone()
        torch.cuda.current_stream().wait_stream(side)
        lsm[tp] = torch.log_softmax(eager[active].float(), dim=-1)
        graph = torch.cuda.CUDAGraph()
        with cuda_build.recording_launches() as rec:
            with torch.cuda.graph(graph, stream=side):
                glog = step()
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(glog[active], eager[active]),
              f"tp: a replay of the {tp}-shard decode step differs from its "
              f"eager step")

        def replay(graph=graph, rec=rec):
            graph.replay()
            cuda_build.credit_launches(rec)

        cuda_build.reset_launch_counts()
        walls = []
        for _ in range(AB_STEPS):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            replay()
            torch.cuda.synchronize()
            walls.append((time.monotonic() - t0) * 1e3)
        launches = {k_: n // AB_STEPS for k_, n in cuda_build.LAUNCHES.items() if n}
        prof = device_profile(replay, PROF_STEPS)
        out[tp] = dict(wall_ms=statistics.median(walls), launches=launches,
                       **prof)
        del graph
    gap = (lsm[1] - lsm[TP]).abs().max().item()
    agree = (lsm[1].argmax(-1) == lsm[TP].argmax(-1)).float().mean().item()
    off32 = {t_: (v - lsm32).abs().max().item() for t_, v in lsm.items()}
    log(f"tp: decode step {TP} shards vs 1: log-softmax gap {gap:.4f} nats, "
        f"argmax agreement {agree:.3f}; against f32 {off32}; " + json.dumps(
            {t_: {k_: v for k_, v in o.items() if k_ != "launches"}
             for t_, o in out.items()}))
    check(off32[TP] <= max(TP_STEP_RATIO * off32[1], floor),
          f"tp: the {TP}-shard decode step sits {off32[TP]:.4f} nats from f32, "
          f"one shard's {off32[1]:.4f} (limit {TP_STEP_RATIO} x, or {floor})")
    n_l = cfg.num_layers
    for name in ("paged_kv_write_fused", "paged_attention"):
        check(out[TP]["launches"].get(name) == TP * n_l
              and out[1]["launches"].get(name) == n_l,
              f"tp: {name} launches a step {out[TP]['launches'].get(name)} on "
              f"{TP} shards, {out[1]['launches'].get(name)} on one "
              f"(want {TP * n_l} and {n_l})")
    return dict(by_tp=out, gap=gap, agree=agree, off32=off32)


def tp_greedy(eng, prompts: list, n: int) -> list[dict]:
    from polyrl_tpu_torch.rollout.sampling import SamplingParams

    return eng.generate(prompts, SamplingParams(temperature=0.0,
                                                max_new_tokens=n,
                                                stop_token_ids=()))


def tp_f32_parity(dev, prompts: list, model: str = MODEL,
                  overrides: dict | None = None) -> dict:
    """At TP_F32_LAYERS layers in f32 (the engines' own f32 pools), greedy
    TP_F32_NEW tokens on TP shards against one shard: tokens equal until
    the first near-tie, logprobs within MOE_F32_TOL."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    cfg = decoder.get_config(model, dtype=torch.float32,
                             **{**(overrides or {}),
                                "num_layers": TP_F32_LAYERS})
    params = decoder.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    kw = dict(max_slots=8, page_size=PS, max_seq_len=1024, num_pages=64,
              prompt_buckets=(256,), kv_cache_dtype=torch.float32, device=dev,
              spec_tokens=0)
    res = {}
    for tp in (1, TP):
        eng = CBEngine(cfg, params, tp=tp, **kw)
        try:
            res[tp] = tp_greedy(eng, prompts, TP_F32_NEW)
        finally:
            eng.stop()
    worst, firsts = 0.0, []
    for p_, a, b in zip(prompts, res[1], res[TP]):
        gaps = top2_gaps(params, cfg, p_, a["token_ids"], dev)
        ok, first, tie, _ = agrees_until_tie(b["token_ids"], a["token_ids"], gaps)
        check(ok, f"tp f32: {TP} shards part from one at token {first} "
              f"(first near-tie {tie})")
        n = first
        if n:
            worst = max(worst, float(np.abs(np.array(a["logprobs"][:n])
                                            - np.array(b["logprobs"][:n])).max()))
        firsts.append((first, tie))
    check(worst <= MOE_F32_TOL, f"tp f32: logprobs {worst:.2e} from one "
          f"shard's (limit {MOE_F32_TOL})")
    return dict(worst=worst, firsts=firsts)


def tp_push(dev, server, params) -> dict:
    """One push through the sharded fabric: a replicated sender (the
    trainer's whole tree, each leaf negated: exact in bf16) into the tp
    server's receiver, which advertises TP shards; every installed shard
    bitwise the sender's slice."""
    from polyrl_tpu_torch.models.quant import named_leaves
    from polyrl_tpu_torch.rollout.serve import attach_receiver
    from polyrl_tpu_torch.transfer.interface import TransferInterface
    from polyrl_tpu_torch.transfer.layout import build_resharding_map

    pushed = {k_: ({kk: -vv for kk, vv in v.items()} if isinstance(v, dict)
                   else -v) for k_, v in params.items()}
    iface = TransferInterface(pushed, manager_client=None, num_streams=4,
                              poll_s=0.05, advertise_host="127.0.0.1")
    try:
        check(attach_receiver(server, iface.sender.endpoint, transfer_streams=4),
              "tp: the server had a receiver already")
        t0 = time.monotonic()
        while not iface.sync_health():
            check(time.monotonic() - t0 < 60, "tp: the receiver never registered")
            time.sleep(0.05)
        t0 = time.monotonic()
        v = iface.update_weights_async(pushed)
        iface.wait_pushed(timeout=120.0)
        queued_s = time.monotonic() - t0
        ok, msg = server.update_weights_from_agent(v)
        check(ok, f"tp: the push did not install: {msg}")
        landed_s = time.monotonic() - t0 - queued_s
        info = server.server_info()
        check(info.get("transfer_shard_tp") == TP,
              f"tp: transfer_shard_tp {info.get('transfer_shard_tp')}")
        spec = server.receiver.shard_spec
        whole = dict(named_leaves(pushed))
        n_split = 0
        for s_, shard in enumerate(server.engine.params):
            for name, t in named_leaves(shard):
                d = spec.axis_of(name)
                want = whole[name] if d is None else whole[name].chunk(TP, d)[s_]
                n_split += d is not None
                check(torch.equal(t, want), f"tp: shard {s_}'s {name} is not "
                      "the sender's slice")
        rmap = build_resharding_map(iface.layout, iface.trainer_spec, spec)
        return dict(version=v, queued_s=queued_s, landed_s=landed_s,
                    bytes=iface.layout.total_bytes,
                    reshard_bytes=rmap.reshard_bytes(), split_leaves=n_split)
    finally:
        iface.close()


def tp_phase(dev, model: str = MODEL, overrides: dict | None = None) -> dict:
    """``serve --tp 2``'s engine (``create_server(tp=2)``) of ``model`` at
    full width and depth (``overrides``: a MoE model's cut depth, its
    dropless factor), both shards on the one card: the serve phase's
    18-stream mix over HTTP as the main path (counts zeroed just before it
    and read just after: the fused prologue, K2 and K3 on both shards,
    graph replays), its greedy streams against a one-shard engine on the
    same weights; at 2 layers in f32 the same against MOE_F32_TOL; the
    decode step by replay on 2 shards and on 1; one push through the
    sharded fabric. A MoE shard holds half of every expert's width and
    the whole router."""
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine
    from polyrl_tpu_torch.rollout.serve import create_server

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    server = create_server(model, device=str(dev), host="127.0.0.1", port=0,
                           model_overrides=overrides,
                           max_slots=S, page_size=PS, max_seq_len=4096,
                           num_pages=TP_PAGES, steps_per_dispatch=8, seed=0,
                           tp=TP)
    try:
        eng = server.engine
        cfg = eng.cfg
        up_gb = torch.cuda.memory_allocated(dev) / 1e9
        k_ptrs = {sp[0][0].data_ptr() for sp in eng._pools}
        check(eng.tp == TP and len(eng.params) == TP and len(k_ptrs) == TP
              and all(sp[0][0].shape[0] == cfg.num_kv_heads // TP
                      for sp in eng._pools),
              "tp: the engine does not hold its shards' own pools")
        if cfg.num_experts:
            for p_ in eng.params:
                lp = p_["layers"]
                check(lp["we_gate"].shape[-1] == cfg.moe_intermediate_size // TP
                      and lp["we_down"].shape[-2] == cfg.moe_intermediate_size // TP
                      and lp["we_gate"].shape[1] == cfg.num_experts
                      and lp["router"].shape[-1] == cfg.num_experts,
                      "tp: a MoE shard does not hold every expert's width "
                      "slice and the whole router")
        port = server.port
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)
        run_requests(port, [{"rid": "warmup", "input_ids": warm,
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 16}}])
        post(port, "/flush_cache", {})
        info0 = post(port, "/get_server_info", None)
        replays0 = eng.graph_replays
        cuda_build.reset_launch_counts()
        t0 = time.monotonic()
        outs = run_requests(port, bodies)
        wall = time.monotonic() - t0
        info = post(port, "/get_server_info", None)
        # then one greedy request alone, as the serve phase's main path
        # ends: the mix alone may never dispatch without a live group (K2)
        run_requests(port, [{"rid": "alone", "input_ids": greedy_prompts[0],
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 64}}])
        launches = dict(cuda_build.LAUNCHES)
        replays = eng.graph_replays - replays0
        n_l = cfg.num_layers
        for name in SERVE_KERNELS:
            check(launches[name] > 0 and launches[name] % (TP * n_l) == 0,
                  f"tp: {name} launched {launches[name]} times on the main "
                  f"path (want a positive multiple of {TP} shards x {n_l} "
                  f"layers)")
        check(launches["paged_kv_write"] == 0, "tp: the unfused K/V write ran")
        check(replays > 0, "tp: no decode dispatch replayed a graph")
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0
                  and all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                  "tp: a non-finite logprob or a token outside the vocabulary")
        tok_s = mix_tok_s(outs)
        delta = {k: info[k] - info0[k] for k in (
            "decode_dispatches", "grouped_decode_dispatches",
            "sibling_attach_dispatches")}
        greedy = [o for b, o in zip(bodies, outs) if b["rid"].startswith("greedy")]
        log(f"tp: the mix {tok_s:.1f} tok/s, {replays} replays, launches "
            + json.dumps({k_: launches[k_] for k_ in SERVE_KERNELS}))

        # the same weights on one shard (create_server's seed), greedy alone
        params = decoder.init_params(
            torch.Generator(device=dev).manual_seed(0),
            decoder.get_config(model, dtype=torch.bfloat16, **(overrides or {})))
        one = CBEngine(cfg, params, max_slots=S, page_size=PS, max_seq_len=4096,
                       num_pages=TP_PAGES, prompt_buckets=(256,), device=dev,
                       copy_params=False)
        with launches_apart({}):
            try:
                ref = tp_greedy(one, greedy_prompts, 128)
            finally:
                one.stop()
            del one
            params32 = f32_copy(params)
            gate = []
            for p_, r_, o in zip(greedy_prompts, ref, greedy):
                gaps = top2_gaps(params32, cfg, p_, r_["token_ids"], dev)
                ok, first, tie, gap = agrees_until_tie(o["tokens"], r_["token_ids"], gaps)
                err = (float(np.abs(np.array(o["logprobs"][:first])
                                    - np.array(r_["logprobs"][:first])).max())
                       if first else 0.0)
                gate.append(dict(ok=ok, first=first, tie=tie, gap=gap, err=err))
                check(ok, f"tp: {TP} shards part from one at token {first} "
                      f"(first near-tie {tie}, f32 gap {gap:.4f})")
                check(err <= TP_LOGP_TOL, f"tp: greedy logprobs {err:.4f} nats "
                      f"from one shard's (limit {TP_LOGP_TOL})")
            del params32
            log(f"tp: greedy vs one shard {gate}")
            f32 = tp_f32_parity(dev, [p_[:200] for p_ in greedy_prompts],
                                model, overrides)
            log(f"tp: f32 at {TP_F32_LAYERS} layers {f32}")
            step = tp_decode_step(dev, params, cfg,
                                  MOE_LOGP_TOL if cfg.num_experts else 0.0)
            push = tp_push(dev, server, params)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        return dict(launches=launches, tok_s=tok_s, wall=wall, delta=delta,
                    replays=replays, gate=gate, f32=f32, step=step, push=push,
                    up_gb=up_gb, peak_gb=peak_gb, model=model,
                    layers=cfg.num_layers, seconds=time.monotonic() - t_phase)
    finally:
        server.stop()


def tp_lines(t: dict, smi: str) -> list[str]:
    tag = f"{smi}, this run"
    st = t["step"]["by_tp"]
    moe = t["model"] != MODEL
    name = "tp moe" if moe else "tp"
    what = (f"{t['model']} full width, {t['layers']} layers, dropless"
            if moe else f"{t['model']} full width and depth")
    lines = [
        f"{name} (serve --tp {TP}, {what}, bf16, both shards "
        f"on the one card; {tag}): the 18-stream mix {t['tok_s']:.1f} tok/s "
        f"in {t['wall']:.2f} s, {t['replays']} graph replays, "
        f"{json.dumps(t['delta'])}; main-path launches "
        + json.dumps({k_: t["launches"][k_] for k_ in SERVE_KERNELS})
        + f"; {t['up_gb']:.2f} GB after the build, peak {t['peak_gb']:.2f} GB",
        f"tp greedy vs one shard on the same weights (first mismatch, first "
        f"f32 near-tie, max |logprob diff| before it; limit {TP_LOGP_TOL}): "
        + "; ".join(f"({g['first']}, {g['tie']}, {g['err']:.4f})" for g in t["gate"])
        + f"; at {TP_F32_LAYERS} layers in f32: max {t['f32']['worst']:.2e} "
        f"(limit {MOE_F32_TOL}), (first mismatch, first near-tie) "
        f"{t['f32']['firsts']}",
        f"tp decode step by replay at the serving tables ({tag}): {TP} shards "
        f"device ms {st[TP]['device_ms']:.3f}, kernels {st[TP]['kernels']:.1f}, "
        f"wall ms median {st[TP]['wall_ms']:.2f}, launches "
        + json.dumps(st[TP]["launches"]) + f"; one shard device ms "
        f"{st[1]['device_ms']:.3f}, kernels {st[1]['kernels']:.1f}, wall ms "
        f"median {st[1]['wall_ms']:.2f}; log-softmax gap {t['step']['gap']:.4f} "
        f"nats, argmax agreement {t['step']['agree']:.3f}; from the f32 step "
        f"{t['step']['off32'][TP]:.4f} / {t['step']['off32'][1]:.4f} nats on "
        f"{TP} shards / 1 (limit {TP_STEP_RATIO} x)",
        f"tp push through the sharded fabric ({tag}): v{t['push']['version']}, "
        f"{t['push']['bytes'] / 1e9:.2f} GB, queued in {t['push']['queued_s']:.2f} s, "
        f"on the wire and installed {t['push']['landed_s']:.2f} s later; "
        f"{t['push']['split_leaves']} "
        f"split leaves over both shards bitwise the sender's slices; the "
        f"resharding map routes {t['push']['reshard_bytes'] / 1e9:.2f} GB by "
        f"shard pair",
        f"phase {name} ({tag}): {t['seconds']:.1f} s wall",
    ]
    if moe:
        lines = [ln if ln.startswith("tp moe") else "tp moe: " + ln
                 for ln in lines]
    return lines


# -- tp lora: adapter-only pushes into tp shards ---------------------------------

# the pushed adapters: ``a`` drawn as ``wrap_lora`` draws it (N(0, 1/r)),
# ``b`` non-zero at this scale, so that ``(alpha / r) a @ b`` moves each
# projection by about a tenth of its base's entries (std 0.02 at init)
TP_LORA_B_STD = 2e-3


def whole_of_shards(shards: list) -> dict:
    """A tp engine's whole tree, new tensors: each split leaf's shard
    blocks concatenated on its ``tp_dim``, a replicated leaf cloned."""
    from polyrl_tpu_torch.models.quant import flatten, unflatten
    from polyrl_tpu_torch.parallel.tensor import tp_dim

    flats = [flatten(t) for t in shards]
    out = {}
    for name, t in flats[0].items():
        d = None if t.dim() == 0 else tp_dim(name, t.shape)
        out[name] = (t.clone() if d is None
                     else torch.cat([f[name] for f in flats], d))
    return unflatten(out)


def tp_lora_server(dev):
    from polyrl_tpu_torch.rollout.serve import create_server

    return create_server(MODEL, device=str(dev), host="127.0.0.1", port=0,
                         max_slots=S, page_size=PS, max_seq_len=4096,
                         num_pages=TP_PAGES, steps_per_dispatch=8, seed=0,
                         tp=TP, lora_rank=LORA_RANK, lora_alpha=16.0)


def tp_lora_push(server, pushed: dict) -> dict:
    """One adapter push through the fabric into ``server``'s sharded
    receiver: the version, the layout's bytes and its entries' bytes, the
    seconds on the wire (queued to the sender's round verified) and to
    install."""
    from polyrl_tpu_torch.rollout.serve import attach_receiver
    from polyrl_tpu_torch.transfer.interface import TransferInterface

    iface = TransferInterface(pushed, manager_client=None, num_streams=4,
                              poll_s=0.05, advertise_host="127.0.0.1")
    try:
        check(attach_receiver(server, iface.sender.endpoint, transfer_streams=4),
              "tp lora: the server had a receiver already")
        t0 = time.monotonic()
        while not iface.sync_health():
            check(time.monotonic() - t0 < 60,
                  "tp lora: the receiver never registered")
            time.sleep(0.05)
        t0 = time.monotonic()
        v = iface.update_weights_async(pushed)
        iface.wait_pushed(timeout=120.0)
        wire_s = time.monotonic() - t0
        ok, msg = server.update_weights_from_agent(v)
        check(ok, f"tp lora: the push did not install: {msg}")
        install_s = time.monotonic() - t0 - wire_s
        info = server.server_info()
        check(info.get("transfer_shard_tp") == TP,
              f"tp lora: transfer_shard_tp {info.get('transfer_shard_tp')}")
        return dict(version=v, wire_s=wire_s, install_s=install_s,
                    bytes=iface.layout.total_bytes,
                    entry_bytes=sum(e.nbytes for e in iface.layout.entries))
    finally:
        iface.close()


def tp_lora_phase(dev) -> dict:
    """``serve --tp 2 --lora-rank 16`` (``create_server(tp=2,
    lora_rank=16)``) of MODEL at full width and depth, bf16, both shards on
    the one card: one adapter push through the sharded fabric
    (``extract_adapters`` of the served wrapped tree with ``a`` and ``b``
    drawn from a seeded generator), then the serve phase's 18-stream mix
    over HTTP as the main path (counts zeroed just before it and read just
    after, with a greedy request alone after it, as in the tp phase).
    Gates: (a) each shard's ``a``/``b`` bitwise the pushed adapters'
    ``tp_dim`` block, the bases bitwise as before, every leaf at its
    address, no decode graph captured before the push captured again; (b)
    the mix's greedy streams bitwise those of a fresh ``tp=2`` LoRA server
    on the same wrapped tree, given the same adapters in process and the
    same mix (both admitting it held, in one order); (c) the same streams
    against a one-shard LoRA engine on the tree, equal until a near-tie and
    logprobs within TP_LOGP_TOL; (d) the fused prologue, K2 and K3 launched
    on both shards, the unfused K1 not. Readings: the push's bytes against
    the adapter template's, its wire and install seconds; the decode step
    by replay on 2 shards and on 1."""
    from polyrl_tpu_torch.models import lora
    from polyrl_tpu_torch.models.quant import LoraWeight, flatten, named_leaves
    from polyrl_tpu_torch.parallel.tensor import tp_dim
    from polyrl_tpu_torch.rollout.cb_engine import CBEngine

    t_phase = time.monotonic()
    torch.cuda.reset_peak_memory_stats(dev)
    server = tp_lora_server(dev)
    try:
        eng = server.engine
        cfg = eng.cfg
        port = server.port
        bodies, greedy_prompts, warm = serving_mix(cfg.vocab_size)
        warm_body = [{"rid": "warmup", "input_ids": warm,
                      "sampling_params": {"temperature": 0.0,
                                          "max_new_tokens": 16}}]
        with launches_apart({}):
            run_requests(port, warm_body)
        graphs0 = dict(eng._graphs)
        check(graphs0, "tp lora: the warm-up captured no decode graph")
        whole = whole_of_shards(eng.params)
        ptrs = [{n: t.data_ptr() for n, t in named_leaves(p_)}
                for p_ in eng.params]
        gen = torch.Generator(device=dev).manual_seed(11)
        layers = dict(whole["layers"])
        for k_, w in whole["layers"].items():
            if isinstance(w, LoraWeight):
                a = torch.randn(w.a.shape, generator=gen, device=dev) * LORA_RANK ** -0.5
                b = torch.randn(w.b.shape, generator=gen, device=dev) * TP_LORA_B_STD
                layers[k_] = LoraWeight(w.base, a.to(w.a.dtype), b.to(w.b.dtype),
                                        w.alpha)
        trained = {**whole, "layers": layers}
        pushed = lora.extract_adapters(trained)
        tmpl_bytes = sum(t.numel() * t.element_size() for _, t in
                         named_leaves(lora.adapter_template(cfg, LORA_RANK)))
        push = tp_lora_push(server, pushed)
        push["template_bytes"] = tmpl_bytes
        check(eng.weight_version == push["version"]
              and push["entry_bytes"] == tmpl_bytes,
              f"tp lora: version {eng.weight_version}, entries "
              f"{push['entry_bytes']} B against the template's {tmpl_bytes}")
        # (a) the shards against the pushed blocks and the bases as before
        want_flat = flatten(trained)  # the bases are whole's
        for s_, shard in enumerate(eng.params):
            for name, t in named_leaves(shard):
                check(t.data_ptr() == ptrs[s_][name],
                      f"tp lora: shard {s_}'s {name} moved")
                src = want_flat[name]
                d = tp_dim(name, src.shape)
                check(torch.equal(t, src if d is None else src.chunk(TP, d)[s_]),
                      f"tp lora: shard {s_}'s {name} is not the "
                      + ("pushed block" if name.endswith((".a", ".b"))
                         else "base as before"))
        del whole

        # the main path: the mix, held to one admission order, then alone
        cuda_build.reset_launch_counts()
        replays0 = eng.graph_replays
        t0 = time.monotonic()
        outs = run_requests(port, bodies, engine=eng)
        wall = time.monotonic() - t0
        run_requests(port, [{"rid": "alone", "input_ids": greedy_prompts[0],
                             "sampling_params": {"temperature": 0.0,
                                                 "max_new_tokens": 64}}])
        launches = dict(cuda_build.LAUNCHES)
        replays = eng.graph_replays - replays0
        n_l = cfg.num_layers
        for name in SERVE_KERNELS:
            check(launches[name] > 0 and launches[name] % (TP * n_l) == 0,
                  f"tp lora: {name} launched {launches[name]} times on the "
                  f"main path (want a positive multiple of {TP} x {n_l})")
        check(launches["paged_kv_write"] == 0,
              "tp lora: the unfused K/V write ran")
        check(replays > 0, "tp lora: no decode dispatch replayed a graph")
        check(all(eng._graphs.get(k_) is g for k_, g in graphs0.items()),
              "tp lora: a decode graph was captured again after the push")
        for o in outs:
            check(all(np.isfinite(o["logprobs"])) and max(o["logprobs"]) <= 0
                  and all(0 <= t < cfg.vocab_size for t in o["tokens"]),
                  "tp lora: a non-finite logprob or a token outside the "
                  "vocabulary")
        tok_s = mix_tok_s(outs)
        greedy = [o for b_, o in zip(bodies, outs)
                  if b_["rid"].startswith("greedy")]
        log(f"tp lora: the mix {tok_s:.1f} tok/s, {replays} replays, launches "
            + json.dumps({k_: launches[k_] for k_ in SERVE_KERNELS}))

        with launches_apart({}):
            # (b) a fresh tp=2 LoRA server on the same wrapped tree, the
            # same adapters given in process (the whole push cut there)
            fresh = tp_lora_server(dev)
            try:
                run_requests(fresh.port, warm_body)
                fresh.update_weights(pushed)
                ref_outs = run_requests(fresh.port, bodies,
                                        engine=fresh.engine)
            finally:
                fresh.stop()
            del fresh
            ref_greedy = [o for b_, o in zip(bodies, ref_outs)
                          if b_["rid"].startswith("greedy")]
            fresh_bitwise = all(a["tokens"] == b_["tokens"]
                                and a["logprobs"] == b_["logprobs"]
                                for a, b_ in zip(greedy, ref_greedy))
            mix_bitwise = all(a["tokens"] == b_["tokens"]
                              and a["logprobs"] == b_["logprobs"]
                              for a, b_ in zip(outs, ref_outs))
            check(fresh_bitwise, "tp lora: the greedy streams differ from a "
                  "fresh tp=2 LoRA server's on the same tree and adapters")
            # (c) one shard on the same tree
            one = CBEngine(cfg, trained, max_slots=S, page_size=PS,
                           max_seq_len=4096, num_pages=TP_PAGES,
                           prompt_buckets=(256,), device=dev, copy_params=False)
            try:
                ref = tp_greedy(one, greedy_prompts, 128)
            finally:
                one.stop()
            del one
            params32 = f32_copy(trained)
            gate = []
            for p_, r_, o in zip(greedy_prompts, ref, greedy):
                gaps = top2_gaps(params32, cfg, p_, r_["token_ids"], dev)
                ok, first, tie, gap = agrees_until_tie(o["tokens"],
                                                       r_["token_ids"], gaps)
                err = (float(np.abs(np.array(o["logprobs"][:first])
                                    - np.array(r_["logprobs"][:first])).max())
                       if first else 0.0)
                gate.append(dict(ok=ok, first=first, tie=tie, gap=gap, err=err))
                check(ok, f"tp lora: {TP} shards part from one at token "
                      f"{first} (first near-tie {tie}, f32 gap {gap:.4f})")
                check(err <= TP_LOGP_TOL, f"tp lora: greedy logprobs "
                      f"{err:.4f} nats from one shard's (limit {TP_LOGP_TOL})")
            del params32
            log(f"tp lora: greedy vs one shard {gate}")
            step = tp_decode_step(dev, trained, cfg)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        return dict(launches=launches, tok_s=tok_s, wall=wall, replays=replays,
                    push=push, fresh_bitwise=fresh_bitwise,
                    mix_bitwise=mix_bitwise, gate=gate, step=step,
                    captures=eng.graph_captures, peak_gb=peak_gb,
                    seconds=time.monotonic() - t_phase)
    finally:
        server.stop()


def tp_lora_lines(t: dict, smi: str) -> list[str]:
    tag = f"{smi}, this run"
    st, pu = t["step"]["by_tp"], t["push"]
    return [
        f"tp lora (serve --tp {TP} --lora-rank {LORA_RANK}, {MODEL} full width "
        f"and depth, bf16, both shards on the one card; {tag}): the push "
        f"v{pu['version']}: {pu['entry_bytes'] / 1e6:.2f} MB of adapters "
        f"(template {pu['template_bytes'] / 1e6:.2f} MB; layout "
        f"{pu['bytes'] / 1e6:.2f} MB with its padding) on the wire in "
        f"{pu['wire_s'] * 1e3:.1f} ms, installed into both shards "
        f"{pu['install_s'] * 1e3:.1f} ms later; every shard's a/b bitwise the "
        f"pushed block, the bases as before, every leaf at its address, no "
        f"graph captured again ({t['captures']} captures in all)",
        f"tp lora ({tag}): the 18-stream mix {t['tok_s']:.1f} tok/s in "
        f"{t['wall']:.2f} s, {t['replays']} graph replays; main-path launches "
        + json.dumps({k_: t["launches"][k_] for k_ in SERVE_KERNELS})
        + f"; the greedy streams against a fresh tp={TP} LoRA server's: "
        f"{'bitwise' if t['fresh_bitwise'] else 'differ'} (the whole mix "
        f"{'bitwise' if t['mix_bitwise'] else 'not bitwise'}); against one "
        f"shard (first mismatch, first near-tie, max |logprob diff| before "
        f"it; limit {TP_LOGP_TOL}): "
        + "; ".join(f"({g['first']}, {g['tie']}, {g['err']:.4f})"
                    for g in t["gate"])
        + f"; peak {t['peak_gb']:.2f} GB",
        f"tp lora decode step by replay at the serving tables ({tag}): {TP} "
        f"shards device ms {st[TP]['device_ms']:.3f}, kernels "
        f"{st[TP]['kernels']:.1f}, wall ms median {st[TP]['wall_ms']:.2f}; "
        f"one shard device ms {st[1]['device_ms']:.3f}, kernels "
        f"{st[1]['kernels']:.1f}, wall ms median {st[1]['wall_ms']:.2f}; "
        f"from the f32 step {t['step']['off32'][TP]:.4f} / "
        f"{t['step']['off32'][1]:.4f} nats (limit {TP_STEP_RATIO} x)",
        f"phase tp lora ({tag}): {t['seconds']:.1f} s wall",
    ]


# -- parallel: the multi-process trainer on one card (PR 15) --------------------

# the two ranks share cuda:0, so the world's backend is gloo (NCCL refuses
# two ranks on one device); the phase is over when both ranks exit, and a
# rank that has not exited by then is a hang
PARALLEL_TIMEOUT_S = 480.0
PARALLEL_OVERRIDES = TRAIN_OVERRIDES + ["parallel.backend=gloo"]
# A and D at this depth of the training cell (full width; B runs it at
# its full 28): A and C cut from 28 layers when D and E joined the phase
# (A took 85.1 s and C 39.8 s there), then from 8 when tp lora and the
# memory phase's tp spill joined the smoke (A 42.2-50.0 s and C 16.0-20.1 s
# at 8); D from 28 to bring the smoke back inside its budget (21.4 s at 28;
# NVIDIA H100 80GB HBM3 at 700.00 W)
PARALLEL_CUT_LAYERS = 4
# C back at 8 layers, PR 16's depth, where its gradient cosine read lowest
# (0.998120): the family readings that close ROADMAP C.2 come from there
TP_GRAD_LAYERS = 8
# D: the pipeline, half the layers a stage, GPipe microbatches of one row
# of the 4-row micro
PP_MICRO = 4
# E: qwen3-30b-a3b at full width, at the depth whose two ranks (rank 0 with
# the colocated engine and the reference copy) fit on the one card
# together; the preset's capacity factor (E's gate compares the ranks with
# one rank on the same micro, so it needs no dropless dispatch)
EP_LAYERS = 2
RING_T = 4096
# the one-rank train phase this one is held to (PERF.md section 5)
ONE_RANK_PEAK_GB = 30.53
# A's peaks on the whole-tree route (rank 0 with the engine, rank 1), which
# the per-layer gather must stay below (PERF.md section 5)
A_PEAK_GB = (27.36, 20.09)


def bit_checksum(tree) -> str:
    """A digest of every leaf's bit pattern, computed on the device: each
    2- or 4-byte word, as an integer, times a position weight, summed in
    int64 (a one-bit difference anywhere changes it)."""
    import hashlib

    from polyrl_tpu_torch.models.quant import named_leaves

    h = hashlib.sha256()
    for name, t in named_leaves(tree):
        flat = t.detach().reshape(-1)
        bits = flat.view(torch.int16 if flat.element_size() == 2 else torch.int32)
        total = 0
        for i in range(0, bits.numel(), 1 << 26):
            c = bits[i:i + (1 << 26)].to(torch.int64)
            w = torch.arange(i, i + c.numel(), device=c.device) % 65521 + 1
            total += int((c * w).sum())
        h.update(f"{name}:{total};".encode())
    return h.hexdigest()[:16]


GLOO_PROBES = ("all_gather_into_tensor", "reduce_scatter_tensor",
               "all_to_all_single", "all_reduce", "broadcast", "send/recv")


def gloo_probe_worker() -> int:
    """One rank of a 2-rank gloo world on cuda:0 running each collective
    of GLOO_PROBES in turn on CUDA tensors as they are, its result
    checked; prints ``PROBE <op> ok`` or ``PROBE <op> refused: <error>``.
    send/recv runs last: its refusal may leave the pair broken or bring
    the process down (the parent reads either)."""
    import torch.distributed as dist

    from polyrl_tpu_torch.parallel import distributed

    dev = distributed.initialize(backend="gloo", device="cuda", timeout_s=60)
    r, w = dist.get_rank(), dist.get_world_size()
    for op in GLOO_PROBES:
        x = torch.arange(4, dtype=torch.float32, device=dev) + 10 * r
        out = torch.zeros(4 * w if op == "all_gather_into_tensor" else 4,
                          device=dev)
        try:
            if op == "all_gather_into_tensor":
                dist.all_gather_into_tensor(out, x)
                want = torch.cat([torch.arange(4.0) + 10 * i for i in range(w)])
            elif op == "reduce_scatter_tensor":
                out = torch.zeros(4 // w, device=dev)
                dist.reduce_scatter_tensor(out, x)
                want = sum(torch.arange(4.0) + 10 * i for i in range(w))[
                    r * (4 // w):(r + 1) * (4 // w)]
            elif op == "all_to_all_single":
                dist.all_to_all_single(out, x)
                want = torch.cat([(torch.arange(4.0) + 10 * i)[r * 2:(r + 1) * 2]
                                  for i in range(w)])
            elif op == "all_reduce":
                out = x.clone()
                dist.all_reduce(out)
                want = sum(torch.arange(4.0) + 10 * i for i in range(w))
            elif op == "broadcast":
                out = x.clone()
                dist.broadcast(out, 0)
                want = torch.arange(4.0)
            else:
                for q in dist.batch_isend_irecv([
                        dist.P2POp(dist.isend, x, (r + 1) % w),
                        dist.P2POp(dist.irecv, out, (r - 1) % w)]):
                    q.wait()
                want = torch.arange(4.0) + 10 * ((r - 1) % w)
            torch.cuda.synchronize()
            ok = torch.equal(out.cpu(), want)
            print(f"PROBE {op} " + ("ok" if ok else f"refused: gave "
                                    f"{out.cpu().tolist()}"), flush=True)
        except Exception as exc:  # noqa: BLE001 — the reading itself
            print(f"PROBE {op} refused: {str(exc).splitlines()[0][:200]}",
                  flush=True)
    os._exit(0)  # a refused send/recv may leave the pair unable to shut down


def gloo_cuda_probe() -> dict:
    """Which collectives gloo takes on CUDA tensors as they are (the port
    stages them through the host either way): one 2-rank world on cuda:0
    running each in turn, given 60 s. "ok", or what it raised, or how the
    world died."""
    root = os.path.dirname(os.path.abspath(__file__))
    port = free_port()
    pair = []
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        pair.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--gloo-probe"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    t0 = time.monotonic()
    texts = []
    for p in pair:
        try:
            texts.append(p.communicate(timeout=max(1.0, 60 - (time.monotonic() - t0)))[0]
                         .decode(errors="replace"))
        except subprocess.TimeoutExpired:
            p.kill()
            texts.append(p.communicate()[0].decode(errors="replace") + "\n(hung)")
    out = {}
    for op in GLOO_PROBES:
        said = [ln.split(f"PROBE {op} ", 1)[1].strip() for t in texts
                for ln in t.splitlines() if ln.startswith(f"PROBE {op} ")]
        if len(said) == 2 and all(x == "ok" for x in said):
            out[op] = "ok"
            continue
        refused = [x for x in said if x != "ok"]
        lines = [ln for t in texts for ln in t.splitlines()
                 if any(w_ in ln for w_ in ("Error", "what()", "hung",
                                            "Exception"))]
        out[op] = (refused[0] if refused else
                   f"no reading (exit {[p.returncode for p in pair]}): "
                   + (lines[-1].strip()[:200] if lines else "no message"))
    return out


# the parameter leaves by family, for the gradient readings by family
LEAF_FAMILIES = {
    "embed": "embed", "lm_head": "head", "final_norm": "final norm",
    "wq": "q/k/v/o", "wk": "q/k/v/o", "wv": "q/k/v/o", "wo": "q/k/v/o",
    "bq": "q/k/v/o", "bk": "q/k/v/o", "bv": "q/k/v/o",
    "q_norm": "q_norm/k_norm", "k_norm": "q_norm/k_norm",
    "w_gate": "gate/up/down", "w_up": "gate/up/down", "w_down": "gate/up/down",
    "router": "router", "we_gate": "experts", "we_up": "experts",
    "we_down": "experts", "attn_norm": "layer norms", "mlp_norm": "layer norms",
}


def _cos_ratio(dot: float, na: float, nb: float) -> tuple[float, float]:
    if na == 0.0 or nb == 0.0:
        return float("nan"), float("nan")
    return dot / (na * nb) ** 0.5, (na / nb) ** 0.5


def mesh_grad_agreement(actor, micro) -> tuple[float, float, dict]:
    """The micro's gradient on the mesh (each rank its rows and its tp,
    pp and ep blocks; each layer's gradient reduce-scattered by its
    backward, the rest at the step, all summed) against one rank's on the
    whole micro through the one-device path (no pipeline), on the same
    gathered weights: (cosine, norm ratio) over every leaf, and the same
    pair for each leaf family (``LEAF_FAMILIES``), both gathered whole on
    every rank (the same on both). The gradients are cleared after, so the
    fit's own micros start clean."""
    from polyrl_tpu_torch.models.quant import named_leaves

    sharded = actor._fsdp
    with torch.enable_grad():
        loss, _ = actor._loss_fn(micro, 1.0)
        loss.backward()
    g_mesh = sharded.gather(sharded.shard_grads())
    for _, p_ in actor._named:
        p_.grad = None
    sharded.release()
    whole = actor.gather_params()
    leaves = dict(named_leaves(whole))
    for n in sharded.names:
        leaves[n].requires_grad_(True)
    keep = actor.params, actor._fsdp, actor.mesh, actor.layers_fn
    actor.params, actor._fsdp, actor.mesh, actor.layers_fn = whole, None, None, None
    try:
        with torch.enable_grad():
            loss, _ = actor._loss_fn(micro, 1.0)
            loss.backward()
    finally:
        actor.params, actor._fsdp, actor.mesh, actor.layers_fn = keep
    sums: dict[str, list[float]] = {}
    for n in sharded.names:
        a, b = g_mesh.pop(0).reshape(-1).float(), leaves[n].grad.reshape(-1).float()
        leaves[n].grad = None
        leaf = n.rsplit(".", 1)[-1]
        fam = sums.setdefault(LEAF_FAMILIES.get(leaf, leaf), [0.0, 0.0, 0.0])
        fam[0] += float(torch.dot(a, b))
        fam[1] += float(torch.dot(a, a))
        fam[2] += float(torch.dot(b, b))
        del a, b
    del whole, leaves
    cos, ratio = _cos_ratio(*(sum(f[i] for f in sums.values())
                              for i in range(3)))
    return cos, ratio, {k_: _cos_ratio(*f) for k_, f in sums.items()}


def _step_walls(history: list[dict]) -> list[dict]:
    keys = ("gen", "broadcast", "reward", "old_log_prob", "ref_log_prob",
            "adv", "update_actor", "update_weight")
    return [dict(step=rec["perf/step_time_s"],
                 **{k_: rec.get("timing_s/" + k_, 0.0) for k_ in keys})
            for rec in history]


def _state_bytes(actor) -> dict:
    n = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    return dict(param_gb=n([p for _, p in actor._named]) / 1e9,
                opt_gb=n(actor.opt_state.mu + actor.opt_state.nu) / 1e9)


def parallel_fsdp_fit(dev, rank: int,
                      axes: tuple = ("parallel.fsdp=2",
                                     cut_depth(PARALLEL_CUT_LAYERS)),
                      after=None) -> dict:
    """A: ``build_trainer`` on the train phase's configuration at fsdp 2
    (each layer gathered in its layer body), one GRPO step; C, D and E the
    same on their axes (``axes``: tp 2; pp 2; ep 2 on qwen3-30b-a3b). The
    logprob and gradient gates on step 1, a digest of the gathered weights
    after each step, ``after(trainer)``'s readings after the fit."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.train import build_trainer

    cfg = load_config(None, PARALLEL_OVERRIDES + ["trainer.total_steps=1"]
                      + list(axes))
    torch.cuda.reset_peak_memory_stats(dev)
    cleanup: list = []
    t0 = time.monotonic()
    trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
    try:
        actor = trainer.actor
        build_s = time.monotonic() - t0
        gate_launches: dict = {}
        step1: dict = {}
        digests: list[str] = []
        fit_peak: list[int] = []
        process, finish = trainer._process_ibatch, trainer._finish_record

        def first_ibatch_gates(ibatch, metrics):
            out = process(ibatch, metrics)
            if step1:
                return out
            mask = np.asarray(out["response_mask"]) > 0
            gap = np.abs(np.asarray(out["old_log_probs"])
                         - np.asarray(out["rollout_log_probs"]))[mask]
            feed = {k_: np.array(out[k_]) for k_ in (
                "input_ids", "positions", "attention_mask", "responses",
                "response_mask", "advantages", "old_log_probs",
                "ref_log_probs", "rollout_log_probs")}
            # the gate holds a whole copy of the weights and two whole
            # gradients: its own peak is kept out of the fit's
            fit_peak.append(torch.cuda.max_memory_allocated(dev))
            with launches_apart(gate_launches):
                cos, ratio, fams = mesh_grad_agreement(actor,
                                                       gate_micro(feed, dev))
            torch.cuda.reset_peak_memory_stats(dev)
            step1.update(gap_max=float(gap.max()), gap_mean=float(gap.mean()),
                         tokens=int(mask.sum()), grad_cos=cos, grad_ratio=ratio,
                         grad_families=fams)
            return out

        def record_then_digest(metrics, state, step_t0, n_traj, history):
            finish(metrics, state, step_t0, n_traj, history)
            with launches_apart(gate_launches):
                digests.append(bit_checksum(actor.gather_params()))
                actor.release_gathered()

        trainer._process_ibatch = first_ibatch_gates
        trainer._finish_record = record_then_digest
        cuda_build.reset_launch_counts()
        t_fit = time.monotonic()
        history = trainer.fit()
        torch.cuda.synchronize()
        fit_wall = time.monotonic() - t_fit
        launches = dict(cuda_build.LAUNCHES)
        free, total = torch.cuda.mem_get_info(dev)
        extra = after(trainer) if after is not None else {}
        sh = actor._fsdp
        push_gb = sum(math.prod(s_) * torch.empty((), dtype=d_).element_size()
                      for s_, d_ in zip(sh.shapes, sh.dtypes)) / 1e9
        return dict(build_s=build_s, fit_wall=fit_wall, launches=launches,
                    push_gb=push_gb, layers=actor.model_cfg.num_layers, **extra,
                    gate_launches=gate_launches, digests=digests,
                    walls=_step_walls(history), step1=step1,
                    finite=all(np.isfinite(r_["actor/grad_norm"])
                               and r_["actor/nonfinite_skips"] == 0
                               for r_ in history),
                    steps=len(history),
                    peak_gb=max(fit_peak + [torch.cuda.max_memory_allocated(dev)]) / 1e9,
                    reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
                    card_used_gb=(total - free) / 1e9, **_state_bytes(actor),
                    weight_version=getattr(trainer.rollout, "weight_version", None))
    finally:
        for fn in reversed(cleanup):
            fn()


def pp_unsplit(trainer) -> dict:
    """D after its step: a digest of the leaves pp does not split (the
    embedding, the final norm, an untied head), each rank's own copy."""
    actor = trainer.actor
    tree = {n: p for (n, p), d in zip(actor._named, actor._fsdp.dims) if not d}
    return dict(unsplit=bit_checksum(tree), unsplit_names=sorted(tree))


def ep_readings(trainer) -> dict:
    """E after its step: the router's digest (replicated: each rank's own
    copy), the share of each of this rank's expert blocks (and of the
    router) that moved from the reference copy, its expert bytes."""
    from polyrl_tpu_torch.parallel import expert
    from polyrl_tpu_torch.parallel.mesh import EP, block

    actor = trainer.actor
    local = dict(actor._named)
    ref = trainer.ref_policy.params["layers"]
    moved = {}
    for key in ("router",) + expert.EXPERT_KEYS:
        mine = local[f"layers.{key}"].detach()
        want = ref[key] if key == "router" else block(
            actor.mesh, ref[key].to(mine.device), EP, 1)
        moved[key] = float((mine != want).float().mean())
    n_bytes = sum(local[f"layers.{k_}"].numel() * local[f"layers.{k_}"].element_size()
                  for k_ in expert.EXPERT_KEYS)
    return dict(router=bit_checksum({"router": local["layers.router"]}),
                moved=moved, expert_gb=n_bytes / 1e9,
                expert_shape=list(local["layers.we_gate"].shape))


def parallel_sp_fit(dev, rank: int) -> dict:
    """B: one fit step at sp 2 (Ulysses) on packed rows: the first pack's
    logprobs under SP against the one-device forward of the same pack,
    and K4 launched with segment ids."""
    from polyrl_tpu_torch.config import load_config
    from polyrl_tpu_torch.trainer.actor import _to_device
    from polyrl_tpu_torch.train import build_trainer

    from polyrl_tpu_torch.parallel import sequence

    # pack_len 1024: two of the train cell's trajectories a row
    cfg = load_config(None, PARALLEL_OVERRIDES + [
        "parallel.sp=2", "parallel.sp_mode=ulysses",
        "trainer.use_remove_padding=true", f"trainer.pack_len={PACK_LEN}",
        "trainer.total_steps=1"])
    torch.cuda.reset_peak_memory_stats(dev)
    seg_calls, exchanges = [0], [0]
    real, real_exchange = flash.flash_attention_train, sequence._seq_to_heads

    def counted(q, k, v, attn_mask, *, causal=True, segment_ids=None):
        if segment_ids is not None and q.is_cuda:
            seg_calls[0] += 1
        return real(q, k, v, attn_mask, causal=causal, segment_ids=segment_ids)

    def counted_exchange(mesh, axis, x):
        exchanges[0] += 1
        return real_exchange(mesh, axis, x)

    flash.flash_attention_train = counted
    sequence._seq_to_heads = counted_exchange
    cleanup: list = []
    try:
        trainer = build_trainer(cfg, cleanup, compute_score=byte_length_score)
        actor = trainer.actor
        gate_launches: dict = {}
        pack_gate: dict = {}
        process = trainer._process_ibatch

        def first_pack_gate(ibatch, metrics):
            out = process(ibatch, metrics)
            if pack_gate:
                return out
            pack, _spec = out.meta_info["packs"][0]
            feed = _to_device({k_: pack[k_] for k_ in PACK_KEYS}, dev)
            main_calls, main_exchanges = seg_calls[0], exchanges[0]
            with launches_apart(gate_launches):
                lp_sp, _ = actor.compute_log_prob_packed(feed, compute_entropy=False)
                mesh, actor.mesh = actor.mesh, None
                try:
                    lp_one, _ = actor.compute_log_prob_packed(
                        feed, compute_entropy=False)
                finally:
                    actor.mesh = mesh
            # the gate's own calls do not count
            seg_calls[0], exchanges[0] = main_calls, main_exchanges
            lm = feed["loss_mask"] > 0
            pack_gate.update(gap_max=float((lp_sp - lp_one).abs()[lm].max()),
                             tokens=int(lm.sum()),
                             segments=int(feed["segment_ids"].max()))
            return out

        trainer._process_ibatch = first_pack_gate
        cuda_build.reset_launch_counts()
        seg_calls[0] = exchanges[0] = 0
        history = trainer.fit()
        torch.cuda.synchronize()
        return dict(launches=dict(cuda_build.LAUNCHES), seg_calls=seg_calls[0],
                    exchanges=exchanges[0],
                    gate_launches=gate_launches, pack=pack_gate,
                    walls=_step_walls(history), steps=len(history),
                    layers=actor.model_cfg.num_layers,
                    peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                    reserved_gb=torch.cuda.max_memory_reserved(dev) / 1e9,
                    **_state_bytes(actor))
    finally:
        flash.flash_attention_train = real
        sequence._seq_to_heads = real_exchange
        for fn in reversed(cleanup):
            fn()


def ring_check(dev) -> dict:
    """Ring attention over the 2 ranks at B 1, T 4096 (Hq 16, Hkv 8, D
    128, bf16; one row packed with 3 segments and pads) against K4 alone
    on the whole row, forward and backward (pad rows' cotangents 0):
    out within FLASH_OUT_TOL at real rows, each gradient within
    FLASH_GRAD_TOL relative error; and both timed (events)."""
    from polyrl_tpu_torch.parallel import mesh as meshlib
    from polyrl_tpu_torch.parallel.sequence import make_ring_attention

    mesh = meshlib.make_mesh(meshlib.MeshConfig(fsdp=1, sp=2), dev)
    c = flash_inputs(dev, 1, RING_T, 13)
    real = (c["seg"] > 0)[..., None, None]
    c["do"] = c["do"] * real
    local = meshlib.shard_batch(mesh, c)
    ring = make_ring_attention(mesh, packed=True)

    def ring_run():
        leaves = [local[n].detach().clone().requires_grad_(True)
                  for n in ("q", "k", "v")]
        out = ring(*leaves, local["mask"], local["seg"])
        return out.detach(), torch.autograd.grad(out, leaves, local["do"])

    def whole(x):
        return meshlib.unshard_batch(mesh, meshlib.all_gather(
            mesh, meshlib.DATA_AXES, x.contiguous()))

    t0 = time.monotonic()
    out, grads = ring_run()
    torch.cuda.synchronize()
    ring_s = time.monotonic() - t0
    out, grads = whole(out), [whole(g) for g in grads]
    with launches_apart({}):
        o4, g4 = wrapper_grads(flash.flash_attention_train, c["q"], c["k"],
                               c["v"], c["mask"], c["seg"], c["do"])
        k4_ms = events_ms(lambda: wrapper_grads(
            flash.flash_attention_train, c["q"], c["k"], c["v"], c["mask"],
            c["seg"], c["do"]), reps=3)
    torch.cuda.synchronize()
    err_o = float((out.float() - o4.float()).abs()[real.expand_as(o4)].max())
    ok_o = bool(torch.allclose(torch.where(real, out, 0).float(),
                               torch.where(real, o4, 0).float(), **FLASH_OUT_TOL))
    rel = {n: float((g.float() - r_.float()).norm() / r_.float().norm())
           for n, g, r_ in zip(("dq", "dk", "dv"), grads, g4)}
    return dict(out_err=err_o, out_ok=ok_o, grad_rel=rel, ring_s=ring_s,
                k4_fwd_bwd_ms=k4_ms)


def parallel_worker(out_dir: str) -> int:
    """One rank of the parallel phase's world (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``/``MASTER_PORT`` from the parent; both ranks on
    cuda:0 over gloo): A, B, the ring check, C, D and E, its readings
    written to ``<out_dir>/rank<R>.json``. A failure writes the traceback
    and leaves at once (the other rank may be waiting in a collective:
    the parent ends it)."""
    import traceback

    from polyrl_tpu_torch.parallel import distributed

    rank = int(os.environ["RANK"])
    path = os.path.join(out_dir, f"rank{rank}.json")
    res: dict = {"rank": rank}
    try:
        dev = distributed.initialize(backend="gloo", device="cuda",
                                     timeout_s=PARALLEL_TIMEOUT_S)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.monotonic()
        res["A"] = parallel_fsdp_fit(dev, rank)
        res["A"]["seconds"] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        res["B"] = parallel_sp_fit(dev, rank)
        res["B"]["seconds"] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        res["ring"] = ring_check(dev)
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        res["C"] = parallel_fsdp_fit(dev, rank, (
            "parallel.tp=2", "parallel.fsdp=1", cut_depth(TP_GRAD_LAYERS)))
        res["C"]["seconds"] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        res["D"] = parallel_fsdp_fit(dev, rank, (
            "parallel.pp=2", "parallel.fsdp=1",
            f"parallel.pp_microbatches={PP_MICRO}",
            cut_depth(PARALLEL_CUT_LAYERS)), after=pp_unsplit)
        res["D"]["seconds"] = time.monotonic() - t0
        gc.collect()
        torch.cuda.empty_cache()
        t0 = time.monotonic()
        res["E"] = parallel_fsdp_fit(dev, rank, (
            "parallel.ep=2", "parallel.fsdp=1", f"model.preset={MOE_MODEL}",
            cut_depth(EP_LAYERS)), after=ep_readings)
        res["E"]["seconds"] = time.monotonic() - t0
    except BaseException:  # noqa: BLE001 — reported to the parent
        res["error"] = traceback.format_exc()
        print(res["error"], file=sys.stderr, flush=True)
        with open(path, "w") as f:
            json.dump(res, f)
        sys.stdout.flush()
        os._exit(1)
    with open(path, "w") as f:
        json.dump(res, f)
    distributed.shutdown()
    return 0


def parallel_phase(dev) -> dict:
    """Two ranks on the one card (processes of this script, gloo), joined
    within PARALLEL_TIMEOUT_S: a failure on either rank, or a hang, fails
    the phase. The gates on what they report."""
    t0 = time.monotonic()
    probe = gloo_cuda_probe()
    probe_s = time.monotonic() - t0
    out_dir = tempfile.mkdtemp(prefix="parallel-")
    port = free_port()
    root = os.path.dirname(os.path.abspath(__file__))
    procs = []
    t0 = time.monotonic()
    for r in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   WORLD_SIZE="2", RANK=str(r), LOCAL_RANK="0")
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        f = open(os.path.join(out_dir, f"rank{r}.log"), "wb")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--parallel-worker",
             out_dir], cwd=root, env=env, stdout=f, stderr=subprocess.STDOUT), f))
    try:
        while any(p.poll() is None for p, _ in procs):
            if (time.monotonic() - t0 > PARALLEL_TIMEOUT_S
                    or any(p.poll() not in (None, 0) for p, _ in procs)):
                break
            time.sleep(0.5)
    finally:
        for p, f in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
            f.close()
    wall = time.monotonic() - t0
    tails = "\n".join(f"--- rank {r} ---\n" + _tail(os.path.join(out_dir, f"rank{r}.log"))
                      for r in range(2))
    check(all(p.returncode == 0 for p, _ in procs),
          f"parallel: rank exit codes {[p.returncode for p, _ in procs]} after "
          f"{wall:.0f} s (limit {PARALLEL_TIMEOUT_S:.0f}):\n{tails}")
    res = []
    for r in range(2):
        with open(os.path.join(out_dir, f"rank{r}.json")) as f:
            res.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    a0, a1 = res[0]["A"], res[1]["A"]
    check(a0["steps"] == a1["steps"] == 1 and a0["finite"] and a1["finite"],
          "parallel A: the fit did not run a finite step on both ranks")
    check(len(a0["digests"]) == 1 and a0["digests"] == a1["digests"],
          f"parallel A: the gathered weights differ between the ranks "
          f"({a0['digests']} / {a1['digests']})")
    for r, a in enumerate((a0, a1)):
        check(a["step1"]["gap_max"] <= LOGP_AGREE_TOL,
              f"parallel A rank {r}: old logprobs {a['step1']['gap_max']:.4f} "
              f"nats from the engine's (> {LOGP_AGREE_TOL})")
        check(a["step1"]["grad_cos"] >= GRAD_COS_MIN_BF16,
              f"parallel A rank {r}: the mesh gradient's cosine against one "
              f"rank's is {a['step1']['grad_cos']:.6f} (< {GRAD_COS_MIN_BF16})")
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            for ph in ("A", "B"):
                check(res[r][ph]["launches"][name] > 0,
                      f"parallel {ph} rank {r}: {name} was not launched")
    # rank 0's colocated engine runs the fused prologue and K2 (the train
    # prompts sit under one 64-token page, so no GRPO group shares a
    # prefix page and K3 is off this path, as in the one-rank train phase)
    for name in TRAIN_KERNELS:
        check(a0["launches"][name] > 0, f"parallel A rank 0: {name} was not launched")
    # the per-layer gather: no whole tree, no whole gradient on any rank
    for r, (a, limit) in enumerate(((a0, A_PEAK_GB[0]), (a1, A_PEAK_GB[1]))):
        check(a["peak_gb"] < limit,
              f"parallel A rank {r}: peak {a['peak_gb']:.2f} GB, not below the "
              f"whole-tree route's {limit} GB")
    c0, c1 = res[0]["C"], res[1]["C"]
    check(c0["steps"] == c1["steps"] == 1 and c0["finite"] and c1["finite"],
          "parallel C: the tp fit did not run a finite step on both ranks")
    check(c0["digests"] == c1["digests"],
          f"parallel C: the gathered weights differ between the ranks "
          f"({c0['digests']} / {c1['digests']})")
    for r, c in enumerate((c0, c1)):
        check(c["step1"]["gap_max"] <= LOGP_AGREE_TOL,
              f"parallel C rank {r}: old logprobs {c['step1']['gap_max']:.4f} "
              f"nats from the engine's (> {LOGP_AGREE_TOL})")
        check(c["step1"]["grad_cos"] >= GRAD_COS_MIN_BF16,
              f"parallel C rank {r}: the tp gradient's cosine against one "
              f"rank's is {c['step1']['grad_cos']:.6f} (< {GRAD_COS_MIN_BF16})")
        for name in ("flash_attention_fwd", "flash_attention_bwd"):
            check(c["launches"][name] > 0,
                  f"parallel C rank {r}: {name} was not launched")
    for name in TRAIN_KERNELS:
        check(c0["launches"][name] > 0,
              f"parallel C rank 0: {name} was not launched")
    d0, d1 = res[0]["D"], res[1]["D"]
    check(d0["steps"] == d1["steps"] == 1 and d0["finite"] and d1["finite"],
          "parallel D: the pp fit did not run a finite step on both ranks")
    check(d0["digests"] == d1["digests"],
          f"parallel D: the gathered weights differ between the ranks "
          f"({d0['digests']} / {d1['digests']})")
    check(d0["unsplit"] == d1["unsplit"] and d0["unsplit_names"],
          f"parallel D: the leaves pp does not split ({d0['unsplit_names']}) "
          f"differ between the ranks ({d0['unsplit']} / {d1['unsplit']})")
    e0, e1 = res[0]["E"], res[1]["E"]
    check(e0["steps"] == e1["steps"] == 1 and e0["finite"] and e1["finite"],
          "parallel E: the ep fit did not run a finite step on both ranks")
    check(e0["digests"] == e1["digests"],
          f"parallel E: the gathered weights differ between the ranks "
          f"({e0['digests']} / {e1['digests']})")
    check(e0["router"] == e1["router"],
          f"parallel E: the router differs between the ranks "
          f"({e0['router']} / {e1['router']})")
    for r, (d, e) in enumerate(((d0, e0), (d1, e1))):
        check(d["step1"]["gap_max"] <= LOGP_AGREE_TOL,
              f"parallel D rank {r}: old logprobs {d['step1']['gap_max']:.4f} "
              f"nats from the engine's (> {LOGP_AGREE_TOL})")
        for ph, x in (("D", d), ("E", e)):
            check(x["step1"]["grad_cos"] >= GRAD_COS_MIN_BF16,
                  f"parallel {ph} rank {r}: the mesh gradient's cosine against "
                  f"one rank's is {x['step1']['grad_cos']:.6f} "
                  f"(< {GRAD_COS_MIN_BF16})")
            for name in ("flash_attention_fwd", "flash_attention_bwd"):
                check(x["launches"][name] > 0,
                      f"parallel {ph} rank {r}: {name} was not launched")
        for key, share in e["moved"].items():
            check(share > 0, f"parallel E rank {r}: its {key} block did not move")
    for ph, x in (("D", d0), ("E", e0)):
        for name in TRAIN_KERNELS:
            check(x["launches"][name] > 0,
                  f"parallel {ph} rank 0: {name} was not launched")
    b0, b1 = res[0]["B"], res[1]["B"]
    for r, b in enumerate((b0, b1)):
        check(b["steps"] == 1, f"parallel B rank {r}: the fit did not run")
        check(b["pack"]["gap_max"] <= LOGP_AGREE_TOL,
              f"parallel B rank {r}: packed logprobs under SP "
              f"{b['pack']['gap_max']:.4f} nats from one rank's (> {LOGP_AGREE_TOL})")
        check(b["seg_calls"] > 0 and b["exchanges"] > 0,
              f"parallel B rank {r}: K4 with segment ids ran "
              f"{b['seg_calls']} times, the Ulysses exchange {b['exchanges']}")
        check(b["pack"]["segments"] > 1,
              f"parallel B rank {r}: pack 0 holds one segment a row")
        ring = res[r]["ring"]
        check(ring["out_ok"] and max(ring["grad_rel"].values()) <= FLASH_GRAD_TOL,
              f"parallel ring rank {r}: against K4 out {ring['out_err']:.3g}, "
              f"grads {ring['grad_rel']}")
    return dict(res=res, wall=wall, probe=probe, probe_s=probe_s)


def family_line(ph: str, step1: dict) -> str:
    """Step 1's micro gradient against one rank's, by leaf family."""
    return (f"parallel {ph} gradient by leaf family, mesh vs one rank "
            f"(cosine / norm ratio, rank 0): " + "; ".join(
                f"{k_} {c:.6f} / {r:.5f}"
                for k_, (c, r) in sorted(step1["grad_families"].items())))


def parallel_lines(p: dict, smi: str) -> list[str]:
    r0, r1 = p["res"]
    a0, a1, b0, b1 = r0["A"], r1["A"], r0["B"], r1["B"]
    c0, c1 = r0["C"], r1["C"]
    tag = f"two ranks sharing one card: {smi}, this run"
    walls = lambda a: "; ".join(  # noqa: E731
        f"step {i} {w['step']:.2f} s (" + ", ".join(
            f"{k_} {v:.2f}" for k_, v in w.items() if k_ != "step") + ")"
        for i, w in enumerate(a["walls"], 1))
    k4 = ("flash_attention_fwd", "flash_attention_bwd")
    lines = [
        f"parallel gloo on CUDA tensors (as they are; the port stages through "
        f"the host; {p['probe_s']:.1f} s): {json.dumps(p['probe'])}",
        f"parallel A (fsdp 2, {MODEL} full width, {a0['layers']} layers, "
        f"bf16; {tag}): "
        f"build {a0['build_s']:.1f} / {a1['build_s']:.1f} s; fit "
        f"{a0['fit_wall']:.1f} s; rank 0 {walls(a0)}",
        f"parallel A rank 1: {walls(a1)}",
        f"parallel A gates: old logprobs vs the engine's max "
        f"{a0['step1']['gap_max']:.4f} / {a1['step1']['gap_max']:.4f} nats over "
        f"{a0['step1']['tokens']} tokens (limit {LOGP_AGREE_TOL}); step 1's "
        f"micro gradient, mesh vs one rank: cosine {a0['step1']['grad_cos']:.6f}, "
        f"norm ratio {a0['step1']['grad_ratio']:.5f} (limit >= "
        f"{GRAD_COS_MIN_BF16}); gathered-weight digests {a0['digests']} on both "
        f"ranks",
        family_line("A", a0["step1"]),
        f"parallel A launches: rank 0 " + json.dumps(a0["launches"]) + "; rank 1 "
        + json.dumps({k_: a1["launches"][k_] for k_ in k4})
        + "; the gates' own " + json.dumps(a0["gate_launches"]),
        f"parallel A memory (per-layer gather): peak allocated rank 0 "
        f"{a0['peak_gb']:.2f} GB, rank 1 {a1['peak_gb']:.2f} GB (whole-tree "
        f"route: {A_PEAK_GB[0]} / {A_PEAK_GB[1]}; reserved {a0['reserved_gb']:.2f} / "
        f"{a1['reserved_gb']:.2f}); card used at the fit's end "
        f"{a0['card_used_gb']:.2f} GB; per rank params {a0['param_gb']:.3f} GB, "
        f"AdamW {a0['opt_gb']:.3f} GB (one rank: the train phase, peak "
        f"{ONE_RANK_PEAK_GB} GB, params {2 * a0['param_gb']:.3f}, AdamW "
        f"{2 * a0['opt_gb']:.3f})",
        f"parallel B (sp 2 ulysses, packed rows of {PACK_LEN}, {b0['layers']} "
        f"layers; {tag}): "
        f"rank 0 {walls(b0)}; rank 1 {walls(b1)}; packed logprobs under SP vs "
        f"one rank on pack 0 ({b0['pack']['segments']} segments, "
        f"{b0['pack']['tokens']} tokens): max {b0['pack']['gap_max']:.4f} / "
        f"{b1['pack']['gap_max']:.4f} nats (limit {LOGP_AGREE_TOL}); K4 calls "
        f"with segment ids {b0['seg_calls']} / {b1['seg_calls']}, Ulysses "
        f"exchanges (q, k, v each) {b0['exchanges']} / {b1['exchanges']}; "
        f"launches rank 0 "
        + json.dumps({k_: b0["launches"][k_] for k_ in k4}) + ", rank 1 "
        + json.dumps({k_: b1["launches"][k_] for k_ in k4})
        + f"; peak allocated {b0['peak_gb']:.2f} / {b1['peak_gb']:.2f} GB "
        f"(reserved {b0['reserved_gb']:.2f} / {b1['reserved_gb']:.2f}); per rank "
        f"params {b0['param_gb']:.3f} GB, AdamW {b0['opt_gb']:.3f} GB",
        f"parallel ring (B 1, T {RING_T}, Hq 16, Hkv 8, D 128, bf16, over 2 "
        f"ranks through host-staged gloo exchanges) vs K4 alone: out max "
        f"{r0['ring']['out_err']:.3g}; grads relative "
        + json.dumps({k_: round(v, 5) for k_, v in r0["ring"]["grad_rel"].items()})
        + f" (limits {FLASH_OUT_TOL}, {FLASH_GRAD_TOL}); ring fwd+bwd "
        f"{r0['ring']['ring_s'] * 1e3:.1f} ms wall (first call), K4 fwd+bwd "
        f"{r0['ring']['k4_fwd_bwd_ms']:.3f} ms",
        f"parallel C (tp 2, {MODEL} full width, {c0['layers']} layers, bf16, "
        f"1 step; {tag}): "
        f"build {c0['build_s']:.1f} / {c1['build_s']:.1f} s; fit "
        f"{c0['fit_wall']:.1f} s; rank 0 {walls(c0)}; rank 1 {walls(c1)}",
        f"parallel C gates: old logprobs vs the engine's max "
        f"{c0['step1']['gap_max']:.4f} / {c1['step1']['gap_max']:.4f} nats "
        f"(limit {LOGP_AGREE_TOL}); step 1's micro gradient, tp vs one rank: "
        f"cosine {c0['step1']['grad_cos']:.6f} / {c1['step1']['grad_cos']:.6f}, "
        f"norm ratio {c0['step1']['grad_ratio']:.5f} (limit >= "
        f"{GRAD_COS_MIN_BF16}); digests {c0['digests']} on both ranks",
        family_line("C", c0["step1"]),
        f"parallel C launches: rank 0 " + json.dumps(c0["launches"]) + "; rank 1 "
        + json.dumps({k_: c1["launches"][k_] for k_ in k4})
        + f"; peak allocated {c0['peak_gb']:.2f} / {c1['peak_gb']:.2f} GB "
        f"(reserved {c0['reserved_gb']:.2f} / {c1['reserved_gb']:.2f}); per rank "
        f"params {c0['param_gb']:.3f} GB, AdamW {c0['opt_gb']:.3f} GB",
    ]
    for ph, what in (("D", f"pp 2, {MODEL} full width, {{layers}} layers "
                           f"({{half}} a stage), {PP_MICRO} GPipe "
                           f"microbatches"),
                     ("E", f"ep 2, {MOE_MODEL} full width, {{layers}} layers, "
                           f"64 experts a rank")):
        x0, x1 = r0[ph], r1[ph]
        desc = what.format(layers=x0["layers"], half=x0["layers"] // 2)
        lines += [
            f"parallel {ph} ({desc}, bf16, 1 step; {tag}): build "
            f"{x0['build_s']:.1f} / {x1['build_s']:.1f} s; fit "
            f"{x0['fit_wall']:.1f} s; rank 0 {walls(x0)}; rank 1 {walls(x1)}",
            f"parallel {ph} gates: old logprobs vs the engine's max "
            f"{x0['step1']['gap_max']:.4f} / {x1['step1']['gap_max']:.4f} nats"
            + (f" (limit {LOGP_AGREE_TOL})" if ph == "D" else " (not gated)")
            + f"; step 1's micro gradient vs one rank: cosine "
            f"{x0['step1']['grad_cos']:.6f} / {x1['step1']['grad_cos']:.6f}, "
            f"norm ratio {x0['step1']['grad_ratio']:.5f} (limit >= "
            f"{GRAD_COS_MIN_BF16}); digests {x0['digests']} on both ranks; "
            + (f"the leaves pp does not split {x0['unsplit_names']}: "
               f"{x0['unsplit']} / {x1['unsplit']}" if ph == "D" else
               f"router {x0['router']} / {x1['router']}; moved shares rank 0 "
               + json.dumps({k_: round(v, 4) for k_, v in x0["moved"].items()})
               + ", rank 1 "
               + json.dumps({k_: round(v, 4) for k_, v in x1["moved"].items()})),
            family_line(ph, x0["step1"]),
            f"parallel {ph} launches: rank 0 " + json.dumps(x0["launches"])
            + "; rank 1 " + json.dumps({k_: x1["launches"][k_] for k_ in k4})
            + f"; peak allocated {x0['peak_gb']:.2f} / {x1['peak_gb']:.2f} GB "
            f"(reserved {x0['reserved_gb']:.2f} / {x1['reserved_gb']:.2f}); "
            f"per rank params {x0['param_gb']:.3f} GB, AdamW "
            f"{x0['opt_gb']:.3f} GB"
            + (f", expert blocks {x0['expert_gb']:.3f} / {x1['expert_gb']:.3f} "
               f"GB (we_gate {x0['expert_shape']})" if ph == "E" else "")
            + f"; the push gathers {x0['push_gb']:.2f} GB, update_weight "
            f"{x0['walls'][0]['update_weight']:.2f} s"]
    lines.append(
        f"phase parallel ({tag}): {p['wall']:.1f} s wall (A {a0['seconds']:.1f} s, "
        f"B {b0['seconds']:.1f} s, C {c0['seconds']:.1f} s, D "
        f"{r0['D']['seconds']:.1f} s, E {r0['E']['seconds']:.1f} s; A and C at "
        f"{a0['layers']} layers; the gloo probe {p['probe_s']:.1f} s before them)")
    return lines


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH", default=None,
                    help="trace the main path's 18 streams with torch.profiler "
                         "and write its kernel table to PATH")
    ap.add_argument("--ppo-ab", action="store_true",
                    help="also run the ppo phase's configuration without "
                         "validation, unpipelined against pipelined in turns, "
                         "and log their step walls")
    ap.add_argument("--grad-seeds", metavar="N,N,...", default="",
                    help="before the phases, read the train phase's micro "
                         "gradient gate after its fit at each of these "
                         "trainer.seed values, with probes of which bf16 "
                         "rounding moves it, and log the spread (not gated)")
    ap.add_argument("--manager-args", metavar="ARGS", default="",
                    help="extra arguments, space-separated, of the manager "
                         "that the disagg and autoscale phases spawn (off by "
                         "default; e.g. '--max-assigned-batches 16')")
    ap.add_argument("--parallel-worker", metavar="DIR", default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--gloo-probe", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    MANAGER_ARGS[:] = args.manager_args.split()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke test "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if args.parallel_worker:
        return parallel_worker(args.parallel_worker)
    if args.gloo_probe:
        return gloo_probe_worker()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True
    ).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}; torch {torch.__version__} CUDA {torch.version.cuda}")

    t_start = time.monotonic()
    with phase_wall("build"):
        # the C++ manager of the remote phases (g++) builds beside the
        # kernels (nvcc)
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            manager = pool.submit(build_manager)
            secs = cuda_build.build()
            log(f"build: {time.monotonic() - t_start:.1f} s wall, per kernel "
                + json.dumps({k: round(v, 1) for k, v in secs.items()}))
            build_report()
            manager.result()
    if args.grad_seeds:
        with phase_wall("grad seeds"):
            grad_gate_sweep(dev, [int(x) for x in args.grad_seeds.split(",")])

    with phase_wall("kernels"):
        rows = check_kernels(dev) + check_flash(dev)
        torch.cuda.empty_cache()
        # the recipe phase's attention layout: rep 4, null norms
        rep4_rows = layout_kernels(dev, RECIPE_HQ, RECIPE_HKV, RECIPE_MODEL,
                                   "llama3-8b")
    # the MoE phase first, while the card's memory is empty: its serving
    # holds 61 GB of weights
    with phase_wall("moe"):
        moe = moe_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        for line in moe_lines(moe, smi):
            log(line)
    log(f"phase moe ({smi}, this run): {moe['seconds']:.1f} s wall")
    with phase_wall("serve"):
        served = serve_phase(dev, profile=args.profile)
    log(f"serve ({smi}, this run): decode {served['decode_tok_s']:.1f} tok/s "
        f"over 18 concurrent streams; TTFT median "
        f"{statistics.median(served['ttft']) * 1e3:.1f} ms, max "
        f"{max(served['ttft']) * 1e3:.1f} ms; again without captures: depth 16 "
        f"{served['runahead']['tok_s']:.1f} tok/s, depth 0 "
        f"{served['runahead']['sync_tok_s']:.1f}; device busy "
        f"{served['runahead']['busy_share']:.3f} of the profiled mix's wall; "
        f"peak {served['peak_gb']:.2f} GB")
    with phase_wall("tp"):
        gc.collect()
        torch.cuda.empty_cache()
        tp = tp_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        for line in tp_lines(tp, smi):
            log(line)
    with phase_wall("tp moe"):
        tp_moe = tp_phase(dev, MOE_MODEL, TP_MOE_OVERRIDES)
        gc.collect()
        torch.cuda.empty_cache()
        for line in tp_lines(tp_moe, smi):
            log(line)
    with phase_wall("tp lora"):
        tp_lora = tp_lora_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        for line in tp_lora_lines(tp_lora, smi):
            log(line)
    # the kernels line's "tp" share: the main paths, dense, MoE and LoRA
    tp_launches = {k_: tp["launches"][k_] + tp_moe["launches"][k_]
                   + tp_lora["launches"][k_] for k_ in tp["launches"]}
    with phase_wall("memory"):
        memory = memory_phase(dev)
        for line in memory_lines(memory, smi) + memory_tp_lines(memory["tp"], smi):
            log(line)
    log(f"phase memory ({smi}, this run): {WALLS['memory']:.1f} s wall")
    with phase_wall("train"):
        trained = train_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
    with phase_wall("ppo"):
        ppo = ppo_phase(dev, args.ppo_ab)
    with phase_wall("kernels"):
        # K4 at the packed rows' shapes, with the packer's segment ids
        flash_case_check(dev, 4, PACK_LEN, 9, "ppo packed rows", reps=5,
                         seg_np=ppo["seg_ids"])
        torch.cuda.empty_cache()
    for name, phase in (("hf", lambda: hf_phase(dev)),
                        ("quant", lambda: quant_phase(dev)),
                        ("lora", lambda: lora_phase(dev, trained["peak_gb"])),
                        ("offload", lambda: offload_checks(dev))):
        with phase_wall(name):
            out = phase()
            gc.collect()
            torch.cuda.empty_cache()
        log(f"phase {name} ({smi}, this run): {WALLS[name]:.1f} s wall")
        if name == "quant":
            log(f"quant ({smi}, this run): launches of the int8 main path: "
                + json.dumps({k_: out["launches"][k_] for k_ in SERVE_KERNELS})
                + "; decode step by replay bf16 / int8: device ms "
                f"{out['ab']['bf16']['device_ms']:.3f} / "
                f"{out['ab']['int8']['device_ms']:.3f}, wall ms "
                f"{out['ab']['bf16']['wall_ms']:.2f} / {out['ab']['int8']['wall_ms']:.2f}")
        if name == "lora":
            log(f"lora ({smi}, this run): K4 launches "
                + json.dumps({k_: out["launches"][k_] for k_ in LORA_KERNELS})
                + f"; peak {out['peak_gb']:.2f} GB against the train phase's "
                f"{trained['peak_gb']:.2f}")

    with phase_wall("features"):
        feats = features_phase(dev, served["ttft"])
        gc.collect()
        torch.cuda.empty_cache()
        for line in features_lines(feats, smi):
            log(line)
    log(f"phase features ({smi}, this run): {WALLS['features']:.1f} s wall")
    with phase_wall("step"):
        stepped = step_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
    log(f"step ({smi}, this run): 16 x (128 + 256) greedy, tok/s "
        f"RolloutEngine {[round(x, 1) for x in stepped['tok_s']['step']]} vs "
        f"CBEngine {[round(x, 1) for x in stepped['tok_s']['cb']]}; vs dense f32 "
        f"worst {stepped['worst'][0]:.4f} / {stepped['worst'][1]:.4f} nats; "
        f"(first mismatch, first near-tie, top-2 f32 gap at the mismatch) vs "
        f"CBEngine {stepped['ties']}; "
        f"GRPO fit on rollout.backend=step: step walls "
        f"{[round(x, 2) for x in stepped['step_walls']]} s (gen "
        f"{[round(x, 2) for x in stepped['gen_walls']]} s), K4 launches "
        + json.dumps({k_: stepped["launches"][k_] for k_ in STEP_KERNELS})
        + f", peak {stepped['peak_gb']:.2f} GB")
    log(f"phase step ({smi}, this run): {WALLS['step']:.1f} s wall")
    # the phases at REMOTE_CUT_LAYERS layers of the training cell
    depth = f"{REMOTE_CUT_LAYERS} of {MODEL}'s 28 layers"
    with phase_wall("disagg"):
        disagg = disagg_phase(dev, trained)
        gc.collect()
        torch.cuda.empty_cache()
        for line in disagg_lines(disagg, smi):
            log(line)
    log(f"phase disagg ({smi}, this run, {depth}): {WALLS['disagg']:.1f} s wall")
    with phase_wall("hybrid"):
        hybrid = hybrid_phase(dev, trained, disagg)
        gc.collect()
        torch.cuda.empty_cache()
        for line in hybrid_lines(hybrid, smi):
            log(line)
    log(f"phase hybrid ({smi}, this run, {depth}): {WALLS['hybrid']:.1f} s wall")
    with phase_wall("lora_delta"):
        delta = lora_delta_phase(dev, disagg)
        gc.collect()
        torch.cuda.empty_cache()
        for line in lora_delta_lines(delta, smi):
            log(line)
    log(f"phase lora_delta ({smi}, this run, {depth}): "
        f"{WALLS['lora_delta']:.1f} s wall")
    with phase_wall("autoscale"):
        scaled = autoscale_phase(dev, disagg)
        gc.collect()
        torch.cuda.empty_cache()
        for line in autoscale_lines(scaled, smi):
            log(line)
    log(f"phase autoscale ({smi}, this run, {depth}"
        f"{'; manager ' + ' '.join(MANAGER_ARGS) if MANAGER_ARGS else ''}): "
        f"{WALLS['autoscale']:.1f} s wall")

    with phase_wall("recipe"):
        recipe = recipe_phase(dev)
        gc.collect()
        torch.cuda.empty_cache()
        for line in recipe_lines(recipe, rep4_rows, smi):
            log(line)
    log(f"phase recipe ({smi}, this run): {WALLS['recipe']:.1f} s wall")

    with phase_wall("parallel"):
        par = parallel_phase(dev)
        for line in parallel_lines(par, smi):
            log(line)

    for r in rows:
        # K1's path is the decode step's unfused route (the serve phase's
        # A/B); K4's the train phase; the rest the serving path
        launches = (served["ab_launches"]["unfused"]
                    if r["name"] == "paged_kv_write" else
                    trained["launches"] if r["name"].startswith("flash")
                    else served["launches"])
        # plus the memory phase's (its tp spill check's too) and the
        # disagg, hybrid, lora_delta, autoscale, recipe, moe and tp paths: the
        # servers decode (the tp servers on both shards), the trainers run
        # K4, and the hybrid's trainer process decodes too (its local
        # engine)
        name = r["name"]
        extra = moe["launches"][name] + tp_launches[name] + recipe[
            "launches"][name] + (
            0 if name == "paged_kv_write" else
                 disagg["trainer_launches"][name]
                 + hybrid["trainer_launches"][name]
                 + delta["trainer_launches"][name]
                 + scaled["trainer_launches"][name] if name.startswith("flash")
                 else disagg["server_launches"][name] + memory["launches"][name]
                 + memory["tp"]["launches"][name]
                 + hybrid["trainer_launches"][name]
                 + hybrid["server_launches"][name]
                 + delta["server_launches"][name]
                 + scaled["a_launches"][name] + scaled["b_launches"][name])
        r.update(route="cuda", source=f"polyrl_tpu_torch/csrc/{r['name']}.cu",
                 replaces=REPLACES[r["name"]],
                 launches=launches[r["name"]] + extra)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    k3 = "grouped_paged_attention"
    print(f"kernels line: each kernel's launches summed over its paths; the "
          f"recipe's {k3} launches "
          f"({recipe['launches'][k3] - recipe['fit_launches'][k3]}) are its "
          f"spec-off group's, its fit's {recipe['fit_launches'][k3]} "
          f"(speculation decodes without group tables)")
    print(smi)
    walls = {k: round(v, 1) for k, v in WALLS.items()}
    walls["total"] = round(time.monotonic() - t_start, 1)
    print(f"phase walls ({smi}, this run, s): {json.dumps(walls)}")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
