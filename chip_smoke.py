#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which makes the script exit non-zero if it fails:
  1. device: the card's name and power limit (nvidia-smi); TF32 is turned
     off for float32 matrix products.
  2. build: the CUDA kernels from paddle_tpu_torch/csrc, timed; fails if
     ptxas reports a spill in any instantiation of the forward or backward
     kernels or ignores a setmaxnreg (warning C7508).
  3. K1: the flash-attention forward kernel against its plain torch version
     on the card in bf16 at the reference's test cases, GQA, d96, the
     edges of the kernel's 128-row block and 128-key ring tiles (sq = sk
     64, 127, 129; sq 1 over sk 300; sq 130 over sk 1000; causal sq 300
     over sk 100, whose first 200 rows admit no key: finite everywhere,
     compared where a row has keys; GQA 8:1 at d64), the serving slice's
     prefill shape, the training slice's attention shape (also in fp16),
     BERT-base's (b32, 12 heads of 64, s512, not causal), Transformer-
     base's (b32, 8 heads of 64, s128), ViT-B/16's (b64, 12 heads of 64,
     s197, not causal: no multiple of a tile) and the decode leg's prefill
     (b8, 16 heads of 128, s128), with times (kernel,
     plain version, and torch's scaled_dot_product_attention as a
     yardstick only) and the least time the card could take. Kernel and SDPA times are given
     twice: the median single call, host work included, and the device
     time per call of 20 back-to-back calls replayed from one CUDA graph
     (no host work between them); the record keeps the latter.
  4. K2: the fused RMSNorm epilogue (K1's kernel with the
     rmsnorm(attn + residual) * gamma flush) against its plain torch
     version in bf16 (and fp16 at two cases): d64, d128, d96 padded
     (mean over the true d), GQA 4/2 and 32/8, ragged s200 and s520,
     sq != sk, K1's edge cases, the prefill and training shapes; its lse
     equal bit for bit to K1's; times as K1's against its bound, the plain
     version, and, as yardsticks only, K1 alone and K1 followed by the
     torch epilogue.
  5. K3/K4: the flash-attention backward kernels against the plain
     backward in bf16 at K1's cases, the edge cases included (and in fp16
     at the training shape and two more), dQ, dK and dV repeated bit for
     bit, and back-to-back times at the training shape and BERT-base's
     with their rate and share of the bound
     (torch's own flash-attention backward as a yardstick only), beside the
     wrapper's delta = rowsum(dO * O) pass. In the causal sq 300 over sk
     100 case the rows of dO that admit no key are zero: such rows are
     undefined in the forward, and with dO zero they add nothing in either
     version.
  6. router: the shipped H100 ledger's decision, with its provenance, at
     the serving prefill shape, the training attention shape and
     BERT-base's (which must each have a ledger row), and
     whether it marks the fused epilogue a winner there. The launch counts
     the later phases expect follow from these decisions.
  7. tiny models on the card against the same weights in float32 on the
     CPU: the logits, then the training step's loss, every gradient and
     one AdamW step.
  8. serving slice: llama_7b in bf16 at full width and depth, random
     weights from seed(0), serving 4 prompts of 512 tokens for 32 new
     tokens, greedy twice and sampled twice (each pair must agree), plus a
     prefill-only run for timing. The K1 launch count must rise by the
     number of layers per generate call where the router picks K1. Then,
     on the same loaded model, generation.WeightOnlyGenerator (int8
     weights, per-output-channel scales, dequantized once per call):
     greedy twice (the runs must agree, every id in the vocabulary) and
     prefill-only, each launching K1 as generate does; prints prefill ms,
     decode ms a step, tokens/s, quantized_bytes against the bf16 weights'
     bytes, peak memory, and, for information only, the share of greedy
     tokens equal to the bf16 stream.
  9. serving engine: the same llama_7b served through
     ContinuousBatchingEngine (8 lanes, blocks of 16, 128 blocks a
     sequence, 1,040 blocks, prefill buckets 64-512 and chunks of 512,
     decode_steps 4): 16 requests of 64 new tokens with prompts of 64-1536
     tokens from RandomState(0), 12 greedy and 4 sampled (temperature 0.8,
     top_k 50, top_p 0.9), half added before the first step and half after
     the third. Three runs: two at decode_steps 4 (the second traced over
     its decode window) and one at decode_steps 1. Every request must end
     with 64 tokens in the vocabulary; the runs must give the same
     streams; every decode graph (greedy and sampled, K 1 and 4) replayed
     must give the tile the same program gives eagerly on the same lane
     state; each prompt's first-chunk logits must agree with the dense
     model forward within ENGINE_LOGITS_RTOL; K1-K4 must not launch from
     the first add_request to the last token; lane-state uploads must not
     outnumber membership changes. Prints prefill-chunk and decode-tile
     device times, tokens/s, TTFT and TPOT medians, the device's busy
     share over the decode window, peak memory and graph captures, and the
     same for generate at batch 8.
  9b. engine knobs, on the same model and engine knobs, every decode
     program a captured CUDA graph and no K1-K4 launch from the first
     add_request to the last token: speculative decode (depth 2, 3-grams)
     on phase 9's mix, whose streams must be phase 9's at decode_steps 4
     and 1, and on 8 greedy requests whose 512-token prompts tile one
     5-token motif (64 new tokens), against the same engine without
     speculation; int8 and fp8_e4m3 pools at the bf16 pool's bytes, which
     must hold 1.9x its blocks, give first-chunk logits within
     QUANT_LOGITS_RTOL of the bf16 pool's and the same streams with and
     without speculation, and one int8 run with serve.kv_dequant forced
     through FLAGS_fault_injection, which must capture again and finish
     every stream; an AdapterStore from demo_store_for_engine (4 adapters
     of rank 8, 8 slots) under 4 base and 4 adapter requests, whose base
     lanes must equal the storeless engine's and adapter lanes repeat
     across two runs, with a fifth adapter registered and served mid-run
     adding no capture; the prefix cache on and off over 8 requests that
     share a 1,024-token prefix (one of them exactly the prefix, so a COW
     fork happens), equal streams; and the SLO scheduler on phase 9's mix
     with 4 best_effort requests and speculation, one forced preemption
     and the ladder stepped to disable_speculation, streams equal to a run
     without them and one capture per program key. Prints, for each run,
     tokens/s, tokens per dispatch, acceptance, TTFT and TPOT medians,
     peak memory and graph captures, and the device time of every decode
     graph, beside the card's name and power limit.
  10. fused epilogue: incubate's fused_attention_rms_epilogue at llama_7b's
     attention widths (b4 s512, 32 heads of 128) and at llama_1.3b's
     training attention shape (b8 s2048, 16 heads), bf16, residual and
     gamma from a seeded numpy draw: one K2 launch per call where the
     ledger marks the fusion a winner, the output against the unfused
     composition.
  12. load generation: llama_7b through ContinuousBatchingEngine at phase
     9's knobs (decode_steps 4, an admission queue of 64) under
     inference.loadgen.run_scenario, each of the six SCENARIOS at its own
     distributions for 6 s of schedule on a fresh engine (shared_prefix
     with the prefix cache, structured_output under an SLOScheduler whose
     ladder only the cost model's headroom moves, a rung a step each way;
     multi_adapter on a cold
     engine without a store, so loadgen installs the demo store). Every
     report must pass loadgen.check_report (the prefix hit rate and
     adapter loads where they apply), and no K1-K4 launch. Then chat at
     5, 10 and 40 requests/s, 6 s each without draining: in every
     run slo_headroom must reach <= 0 no later than the timeline sample
     where shed passes 10%, and its median over the run must separate the
     rates: > 0 at the lowest rate (about half the saturated goodput_rps)
     and <= 0 at every rate that sheds more than 10% (at least one
     does). In every
     run each program's pir_cost_ratio at its end (its last dispatch's
     CUDA-event time over the calibrated price) must lie in [0.2, 5].
     Prints per run
     goodput, TTFT and TPOT p50/p95, shed, the headroom floor and median,
     the calibration scale of each kind of program (graph replays, eager
     prefill chunks), each program's calibrated cost and ratio, and
     adapter swap recompiles.
  13. predictor: the same llama_7b saved by jit.save (InputSpec [4, 512]
     int64; a torch.export program that takes the params as an input)
     into a temporary directory, then create_predictor(Config(prefix)) on
     the card, run twice on phase 8's prompts: the runs must agree bit for
     bit, the logits must agree with the model's eager forward within
     PREDICTOR_LOGITS_RTOL of the largest |logit|, the program must hold
     the flash_fwd operator once per layer, and K1 must launch once per
     layer per run where the router picks it at this shape. Prints save
     and load seconds, the artifact's bytes, the run's and the eager
     forward's device times and the run's peak memory.
  11. training slice: llama_1.3b (bench.py's top rung) in bf16 at full
     width and depth, batch 8, sequence 2048, per-layer remat, chunked LM
     loss, AdamW: one warm-up step and 8 timed steps through
     paddle_tpu_torch.tools.train_llama.run_one. Every loss must be finite,
     the last below the first, and with the router's choice of the
     kernels each step must launch K1 twice per layer (forward and remat
     recompute) and K3 and K4 once per layer. It runs after 12 and 13,
     once llama_7b is freed.
  14. BERT: bert_base(dropout=0.0) pretraining as bench.py measures it
     (parameters cast to bf16, batch 32, sequence 512, AdamW at lr 1e-4,
     15% MLM labels) through paddle_tpu_torch.tools.train_bert.run_one:
     one warm-up step and 8 timed steps. Every loss finite, the last below
     the first, and with the router's choice of the kernels each step
     launches K1, K3 and K4 once per layer (attention without a mask and
     without the causal flag). One more step traced gives kernel time by
     class. Then the same steps under FLAGS_flash_attention_backend=xla:
     no kernel launch, and the first loss within BERT_LOSS_RTOL of the
     routed run's.
  15. GPT: gpt3_1p3b in bf16 (random weights from seed(0)) generating 32
     greedy tokens for 4 prompts of 128 from RandomState(0) through
     model.generate, the recompute path: one whole forward a token. The
     first call is the warm-up, in which the router measures each new
     causal length on a ledger miss; the second is timed and must give
     the same ids and launch K1 once per layer for each length routed to
     it (768 if all are). The last forward's logits under the routed
     backend must agree with the dense backend's within GPT_LOGITS_RTOL of
     the largest |logit|; its kernel time by class is printed.
  16. ResNet-50: bench.py's `_bench_resnet` on the card through
     paddle_tpu_torch.tools.train_resnet.run_one: resnet50 (1000 classes,
     random weights from seed(0)) with its parameters and batch-norm
     buffers cast to bf16, batch 64 of 224 x 224 images from
     RandomState(0), Momentum(0.1, 0.9), one warm-up step and 8 timed
     steps with cuDNN's autotuner off (torch's default), then the same in
     float32 (TF32 off); prints images/s, step ms, resnet_mfu (FLOPs from
     the model's own convolutions and head), peak memory and losses of
     each. One more bf16 step traced gives kernel time by class
     (convolutions, pooling, layout transposes apart) and the busy
     share; another, in a fresh process with cuDNN's autotuner on, the
     same with its algorithms. Both runs: losses finite, the first update lowering
     the loss (the last need not: at lr 0.1 with momentum 0.9 on one
     batch the loss rises again from the third step, PERF.md), no K1-K4
     launch, every batch norm's running statistics finite after the steps
     and the stem's running mean moved from zero. A float32 copy of the
     model at b4 224 x 224 must give the CPU's training-mode logits within
     RESNET_F32_RTOL of the largest |logit|, and the bf16 first loss must
     lie within RESNET_BF16_LOSS_RTOL of the float32 model's on the same
     batch.
  17. decode: bench.py's `_bench_decode` bf16 and int8 legs on the card
     through paddle_tpu_torch.tools.bench_decode.run_one (vocab 32000,
     hidden 2048, FFN 5504, 8 layers, 16 heads, bf16, b8, prompt 128, 128
     new tokens, greedy): bench.py's decode_prefill_ms,
     decode_per_token_ms, decode_tokens_per_s, decode_int8_per_token_ms,
     decode_int8_tokens_per_s and decode_int8_weight_mb, peak memory of
     each leg and K1 launches per call (one per layer where the router,
     asked first, picks K1 at the b8 s128 prefill). decode_int8_weight_mb
     must be 574.3, and the int8 greedy stream must equal bit for bit
     generate's on a fresh build of the model whose matmul weights are the
     generator's own dequantized bf16 tensors. Then weight_quantize and
     llm_int8_linear on the card must equal their CPU results bit for bit
     at 8 tokens of k2048 n5504 (one outlier column) and at 39 tokens of
     k1001 n515 (k and n no multiples of 8).
  18. vision zoo: MobileNetV2 (scale 1.0, 1000 classes) trained as phase 16
     trains ResNet-50, through train_resnet.run_one(zoo_config(
     "mobilenet_v2", "cuda")): parameters and batch-norm buffers in bf16,
     batch 64 of 224 x 224 images, Momentum(0.1, 0.9), one warm-up step
     and 8 timed steps, cuDNN's autotuner off; prints step ms, images/s,
     MFU (conv_linear_macs, a grouped convolution counted by its weight's
     rows), peak memory, one traced step's kernel time by class with
     depthwise convolutions a class of their own (kernels named so, and
     those a depthwise convolution launches and a dense one does not,
     found by probing both first) and the busy share; the same for DenseNet-121, with the time
     of torch.cat's kernels. Losses finite, the first update lowering
     the loss, running statistics finite and moved, a float32 copy's
     training-mode logits at b4 within RESNET_F32_RTOL of the CPU's, the
     bf16 first loss within RESNET_BF16_LOSS_RTOL of a float32 run's.
     Then the flagship of every other family (mobilenet_v1,
     mobilenet_v3_small, mobilenet_v3_large, densenet121, alexnet,
     squeezenet1_1, shufflenet_v2_x1_0, googlenet, inception_v3 at
     299 x 299), one warm-up and 2 timed bf16 steps each at b64 through
     the same run_one: losses finite (dropout at 0.5 in some: the loss
     need not fall), a float32 copy's training-mode outputs at b2 (dropout
     off) within RESNET_F32_RTOL of the CPU's; prints step ms, images/s,
     parameters and peak memory. Then the new ops on the card against
     their CPU results: conv2d_transpose at a decoder's shape (b8,
     256 -> 128 channels, 64 x 64, kernel 4, stride 2, padding 1) in
     float32 (TF32 off, ZOO_OPS_F32_RTOL) and bf16 (ZOO_OPS_BF16_RTOL), and
     with padding "SAME" and a 2 x 2 kernel at stride 3; max_pool2d with
     return_mask on a ReLU'd tensor and max_unpool2d (indices and values
     exactly equal); roi_align at a Mask R-CNN FPN level (2 x 256 x 200 x
     304, 512 boxes, 7 x 7, sampling ratio 2); deform_conv2d at 2 x 64 x
     64 x 64 with a 3 x 3 kernel, with and without a mask; nms over 1000
     boxes (the same indices in the same order), each timed. No K1-K4
     launch over the phase. Prints the phase's seconds.
  19. the high-level API (Model, amp, io, metric, vision.datasets):
     (a) resnet50 (102 classes, float32 weights from seed(0)) on the
     synthetic Flowers-102 resized to 224 x 224 and normalized by
     vision.transforms, through Model.prepare(Momentum(PiecewiseDecay,
     0.9, L2Decay(1e-4)), CrossEntropyLoss, Accuracy(topk=(1, 5)),
     amp_configs="O1") and fit(batch_size 64, num_iters 9, 4 loader
     threads, eval_data Flowers("valid"), LRScheduler and
     ModelCheckpoint callbacks); then Model.load of the checkpoint into a
     fresh Model and evaluate again. Prints images/s over the 8 timed
     iterations (loader included), the loader alone, train_batch ms with
     the batch on the card, a traced train_batch's kernel time by class
     and busy share, peak memory, the GradScaler's scale and skipped
     steps, top-1/top-5. Holds: the O1 cast table of one forward (each
     hooked op's name and input dtypes: 53 convolutions and the linear in
     bf16, 53 batch norms and cross_entropy in float32) equal to the
     CPU's; the first train_batch's loss within RESNET_BF16_LOSS_RTOL of
     the CPU port's under O1 on the same weights and batch; parameters and
     optimizer state after load bit-equal to those saved and the second
     evaluate equal to the first; no K1-K4 launch. (b) bert_base as phase
     14 with PaddleNLP's optimizer (AdamW, LinearWarmup into
     PolynomialDecay, apply_decay_param_fun without biases and norms,
     ClipGradByGlobalNorm(1.0)) through train_bert.run_one, 1 + 4 steps:
     step ms beside phase 14's, K1/K3/K4 once per layer a step as routed,
     the losses finite and falling, one step's global norm within
     HAPI_CLIP_NORM_RTOL of a float64 sum of the same gradients. (c)
     examples/train_lenet_mnist.py on the port: LeNet, Adam(1e-3), one
     epoch of MNIST("train") at b64, evaluate on MNIST("test") at b128,
     the accuracy within HAPI_LENET_ACC_ATOL of the CPU port's run from
     the same weights and shuffles.
  20. machine translation, the models written as a user writes them (an
     nn.Layer of the port's layers). (a) Transformer-base (Vaswani et al.
     2017, Table 3 "base": nn.Transformer(512, 8, 6, 6, 2048, dropout 0.1,
     no attention or ReLU dropout), one shared 37,000-token vocabulary tying
     both embeddings and the pre-softmax projection, embeddings times
     sqrt(512) plus sinusoidal positions, the causal tgt_mask from
     generate_square_subsequent_mask, cross_entropy with label smoothing
     0.1, Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000)), bf16, b32 x
     128 source and target tokens, 1 + 8 steps: step ms, tokens/s, MFU and
     its formula, the router's decision at the three attention shapes (the
     encoder's self-attention and the cross-attention routed, the
     decoder's masked self-attention dense), K1/K3/K4 launches a step (12
     each where routed to the kernels), a traced step by kernel class and
     busy share, peak memory; its float32 twin at 2 + 2 layers, dropout
     and TF32 off, first loss and gradient norm on the card within
     MT_TWIN_LOSS_RTOL / MT_TWIN_GRAD_RTOL of the CPU's. (b) tensorflow/
     nmt's iwslt15 recipe: a bidirectional LSTM encoder, two LSTMCells
     with input feeding and Luong dot attention through nn.RNN, 17,191 /
     7,709 vocabularies, 512 units, dropout 0.2, float32, b128 x 50, SGD
     at 1.0 with ClipGradByGlobalNorm(5): 1 + 4 steps (step ms, tokens/s,
     traced step, peak memory), then 32 sentences at beam 10 through
     BeamSearchDecoder and dynamic_decode (max 100 steps; decode ms, ms a
     decode step, tokens/s, traced decode, peak memory); with dropout off
     the CPU forced along the card's beams (ReplayBeamSearch): at every
     step the card's top scores within NMT_SCORE_ATOL of the CPU's totals
     of the same extensions, and the card's picks a near-tie in the CPU's
     own ranking where they differ (NMT_TIE_ATOL); no K1-K4 launch on (b).
  21. a Vision Transformer and a diffusion U-Net, written as a user
     writes them (nn.Layer of the port's layers and functionals, random
     weights from seed(0), data from numpy seeds). (a) ViT-B/16 trained as
     DeiT-B: AdamW (weight decay 0.05) under CosineAnnealingDecay, mixup
     (lambda ~ Beta(0.8, 0.8) drawn with numpy), F.label_smooth(0.1) into a
     soft-label cross_entropy, stochastic depth 0.1 by paddle.rand,
     attention as one Linear(768, 2304) reshaped into
     F.flash_attn_qkvpacked, bf16, b64 x 224^2, 1 + 8 steps: step ms,
     images/s, MFU and its formula, the router's decision at (b768, s197,
     d64), K1/K3/K4 launches a step (12 each where routed to the
     kernels), a traced step by kernel class and busy share, peak memory;
     its float32 twin at 2 layers, drop path and TF32 off, first loss and
     gradient norm on the card within VIT_TWIN_LOSS_RTOL /
     VIT_TWIN_GRAD_RTOL of the CPU's. (b) DDPM on CIFAR-10 (Ho et al.
     2020: ch 128, ch_mult (1, 2, 2, 2), 2 blocks a level, attention at 16
     x 16 through the dense path, GroupNorm(32), dropout 0.1, nearest x2
     by F.interpolate, 35.7M parameters; T 1000, linear betas, epsilon MSE,
     Adam(2e-4)), float32, b128 x 32^2, t by paddle.randint and noise by
     paddle.randn, 1 + 4 steps, then 20 ancestral sampling steps at b16:
     step ms, images/s, ms a sampling step, traced steps by kernel class
     and busy shares, peak memory, no K1-K4 launch; its twin at ch_mult
     (1, 2), dropout and TF32 off, b8: one training step's loss and
     gradient norm and one sampling step's output on the card against the
     CPU's. (c) every function the slice ported (tensor math, stat, random,
     linalg and paddle.linalg, extras, the in-place family, the nn
     functionals) once on CUDA on the CPU tests' kinds of input, against
     the port's CPU result within NEW_OPS_RTOL of the largest |value|;
     random draws by support and mean, decompositions by what is unique
     (singular values and reconstructions, |R| and Q R, sorted
     eigenvalues, P L U). Prints the phase's seconds.
  22. second-order gradients, the slice's modules written as a user
     writes them: LlamaForCausalLM at llama_1.3b's width and depth
     (train_llama.llama_ladder()[0]'s config) in bf16, random weights
     from seed(0), one sequence of 2048 tokens from a seeded generator
     (the smallest batch the router sends to K1 if not b1). The LM loss
     backward through loss.backward() (K1 once a layer, K3 and K4 once a
     layer where routed), then g = paddle_tpu_torch.grad(loss, params,
     create_graph=True) (K1 once a layer, no K3/K4: the dense forward's
     backward) and Hessian-vector products Hv = grad(sum(g . v)) (K3/K4
     once a layer each, the first order through K1's node) timed with
     device.Event: a random unit v, a second one u for symmetry
     (|u.Hv - v.Hu| / (|u| |Hv|) within HVP_SYMMETRY_TOL) and
     HVP_POWER_STEPS steps of power iteration printing the Rayleigh
     quotient; g within HVP_FIRST_ORDER_RTOL (relative L2) of
     loss.backward()'s, Hv within HVP_DENSE_RTOL of Hv with
     FLAGS_flash_attention_backend=xla (no launch); every value finite;
     peak memory from device.cuda. Then amp.debugging's checker on the
     card (a NaN placed into a layer's activation raises naming the op,
     sqrt at zero raises in the backward; off, no scan), the device API
     (a stream, events, set_stream, the memory counters), and the
     slice's functions once on CUDA against the CPU (fft, signal, the
     audio features, the fp8 GEMM with the path each case took, and
     autograd's vjp/jvp/jacobian/hessian through sdpa's kernel branch,
     which must launch K1) within SLICE_TOLS.
  23. graphs, 2:4 sparsity, the MoE layer and distribution, the models
     written as a user writes them on the port's API, random data from
     seed(0). (a) GraphSAGE-mean (geometric.send_u_recv) and GCN
     (sparse.matmul on the symmetric-normalised CSR adjacency with self
     loops) at ogbn-arxiv's size (Hu et al. 2020: 169,343 nodes,
     1,166,243 edges made symmetric, 128 features, 40 classes; the graph
     drawn with numpy), OGB's arxiv baselines (3 layers, hidden 256,
     BatchNorm1D, dropout 0.5, Adam at 0.01, float32), 1 + 10 full-batch
     steps each: step ms, edges/s, peak memory, a traced step by kernel
     class (gathers, scatter/index-add, GEMMs, sorts, elementwise) and
     the busy share; losses finite, the first update lowering the loss,
     the first step's logits and loss (dropout off) within GRAPH_CPU_RTOL
     of the CPU's at full size; then two GraphSAGE mini-batches of 1,024
     seeds, fanouts [15, 10, 5], through sample_neighbors and
     reindex_graph on the host (host ms to sample against device ms to
     step; the sampler's contract on the first hop). (b) bert_base at
     bench.py's b32 s512 bf16 through train_bert's TrainStep, pruned 2:4
     by incubate.asp.prune_model (the NSP head excluded) with asp.decorate
     around its AdamW, 1 + 4 steps: every pruned weight at density 0.5
     and check_sparsity true after the steps, no mask on the embeddings
     and norms, the card's masks equal to the CPU's for the same weights
     (ties at the boundary counted), K1, K3 and K4 once a layer a step as
     routed, finite losses; the step's ms beside phase 14's. (c)
     incubate's MoELayer at Mixtral-8x7B's block width (d_model 4096, 8
     SwiGLU experts of 14336, top-2, GShardGate), bf16, 4,096 tokens,
     forward and backward: ms, peak memory, executed against useful TFLOP
     (the dense form runs every expert on every token), the aux loss, the
     bf16 output against a float32 twin on the first 512 tokens (those
     whose top-2 experts agree) within MOE_BF16_RTOL. (d) the slice's
     functions (distribution, sparse and sparse.nn with a SubmConv3D,
     geometric, incubate's segment, graph and fused softmax ops,
     LookAhead/ModelAverage steps, SwitchGate, asp.create_mask) once on
     CUDA against the CPU within SLICE17_TOLS, draws by support and mean;
     incubate.autotune.set_config round trips.
  24. the framework plumbing and the process layer of distributed. (a) a
     hubconf.py written to a temporary directory; hub.list and hub.load
     build LlamaForCausalLM at llama_1.3b's widths and full depth
     (train_llama.llama_ladder()[0]: hidden 2048, 16 heads of 128, 24
     layers), bf16, random weights from seed(0); greedy generate of
     PLUMB_NEW tokens after PLUMB_SEQ-token prompts (the smallest batch
     whose prefill the router sends to K1);
     static.save_inference_model(layer=model, input_spec=) at the
     prompts' shape, load_inference_model, one run of the loaded program
     on the prompts, whose logits must be within PREDICTOR_LOGITS_RTOL of
     the model's forward before saving and which must launch K1 once a
     layer, and a model of other weights (seed 1) given the loaded state:
     its greedy tokens, generated under the port's Profiler, must equal
     the model's before saving, each prefill must launch K1 at least once
     a layer, and the events export_protobuf wrote, read back, must hold a
     K1 kernel record. Prints the save, load and generate seconds and peak
     memory, taken while (e) and (f) run beside them.
     (b) a static.nn program (conv2d, batch_norm, fc, layer_norm) under
     program_guard, built on the CPU and on the card, the registry carried
     over by name: the card's output within STATIC_NN_RTOL of the CPU's;
     static.save/load round-trips the card's program; cond, while_loop
     and scan on CUDA tensors. (c) utils.cpp_extension.load builds a C++
     op written to a temporary file with g++ and calls it on CUDA
     tensors (the result on the card, equal to 2x + y). (d)
     utils.run_check, version.show and the version queries, sysconfig,
     and an NCCL request for more ranks than cards refused. (e) the
     port's launcher starts two ranks with --backend gloo on the one card
     running tools/collective_drill.py on CUDA tensors: both exit 0 and
     every value is the reference drill's (tests/two_proc_worker.py). (f)
     `python -m paddle_tpu_torch.tools.loadgen --scenario chat --seed 0
     --dashboard` exits 0 and renders the dashboard. (e) and (f) are
     subprocesses that run beside (a)-(d).
  25. DTensor, auto-parallel, fleet, ZeRO and the distributed checkpoint,
     on the one card: a mesh of several process ids lies on it, each
     tensor holding its global value and carrying its placements. (a)
     llama_1.3b (train_llama.llama_ladder()[0]: hidden 2048, 16 heads of
     128, FFN 8192, 24 layers) in bf16, random weights from seed(0),
     trained 1 + DIST_STEPS AdamW steps through
     distributed.to_static(model, loader, None, AdamW, Strategy) with
     mp_degree 2 and sharding (degree 2, stage 3), LLAMA_SHARDING_RULES,
     so a 2x2 mesh, at b8 s2048 if dist_reckoning leaves DIST_FREE_GIB
     of the card free (else b4), ids from a seeded generator; the same
     weights and batch through a one-process mesh (DP_ONLY_RULES, stage 0)
     first. Losses, parameters and AdamW moments must be bit for bit
     equal between the two; the first loss within DIST_PLAIN_LOSS_RTOL of
     model(ids, labels=ids); every parameter's and moment's chunk map the
     one its ZeRO spec gives; K1 once a layer a step and K3/K4 once a
     layer where routed. Prints step ms, tokens/s, MFU, launches a step
     and peak memory of both. (b) distributed.save_state_dict of the 2x2
     layout's parameters and moments (parameters only if the temporary
     disk holds less than twice their bytes): one file per distinct chunk,
     their data bytes the tensors' bytes; load_state_dict onto a
     one-process layout, an mp=4 layout and plain tensors, each bit for
     bit equal and reading each overlapping chunk once (files and bytes
     counted); a corrupt chunk refused with CheckpointCorruptionError
     naming it; save and load seconds and GB/s. (c) fleet.init with mp 2
     and pp 2; a decoder written from VocabParallelEmbedding,
     Column/RowSequenceParallelLinear, Column/RowParallelLinear, causal
     F.scaled_dot_product_attention and ParallelCrossEntropy (FLEET: 4
     layers at hidden 2048, bf16, b8 s2048) as a PipelineLayer of
     LayerDescs, 1 + DIST_STEPS steps through
     PipelineParallel.train_batch (4 micro-batches) and
     fleet.distributed_optimizer(AdamW): losses within FLEET_LOSS_RTOL of
     the same layers run unwrapped with micro-batch accumulation, K1/K3/K4
     once a layer a micro-batch where routed. (d)
     DataParallel(SyncBatchNorm.convert_sync_batchnorm(resnet50)) through
     group_sharded_parallel(level="p_g_os"), one float32 Momentum step at
     b64 224 x 224 with cuDNN deterministic: loss and state equal to the
     plain model's step; save_group_sharded_model reloads bit for bit.
  26. the pipeline schedules, ring attention, expert parallelism, the
     parameter server and the training guards, on the one card (a mesh of
     several process ids lies on it). (a) llama_1.3b
     (train_llama.llama_ladder()[0]), bf16, random weights from seed(0),
     trained 1 + PIPE["steps"] AdamW steps through LlamaPipeRunner under
     1F1B on a ProcessMesh with pp 4 (6 layers a stage), b8 s2048 in 8
     micro-batches of b1, with FLAGS_flash_attention_backend and _bwd set
     to pallas so the stages run K1/K3/K4; the same weights and batches
     through the plain step (the model's own layers, the runner's loss,
     the same micro-batch accumulation): losses and every parameter after
     each step bit for bit equal; then one step each of FThenB (in 4
     micro-batches of b2 if pipe_reckoning leaves less than
     DIST_FREE_GIB), ZB and VPP (2 chunks of 3 layers) from the same
     weights, each first loss within PIPE_FIRST_LOSS_RTOL of 1F1B's and
     its gradients within PIPE_GRAD_RTOL of 1F1B's first (relative L2 per
     tensor and layer), a planted wrong micro-batch beyond it; every step's K1/K3/K4 launches as
     pipe_launches reckons them; step ms, tokens/s, MFU and the schedule's
     peak memory (forward and backward, before the update) above each
     step's start; that peak less the gradients' bytes, 1F1B's below
     FThenB's. (e) (a)'s 1F1B
     runner under TrainSupervisor: an injected train.step_nonfinite skips
     its step with the parameters restored and the counter +1, a
     preemption saves the parameters and exits with code 0, resume()
     reloads and the next loss equals the skipped step's; a Watchdog of
     GUARD_TIMEOUT fires on a step that sleeps GUARD_SLEEP and dumps the
     stacks. (b) ring_attention over a sep ring of 4 at b1 s32768 h16 d128
     bf16 (8192 tokens a shard), K1 once a ring step, causal and not:
     within RING_OUT_RTOL (relative L2) of flash_attention_bshd over the
     whole sequence and, causal, of the dense ring, a planted fault (the
     last shard without its first block) beyond it; then its backward (the dense
     ring's) at the largest of RING_BWD_SEQS that ring_dense_bytes leaves
     RING_BWD_FREE_GIB beside, dq/dk/dv within RING_GRAD_RTOL of K3/K4's;
     K1 at the ring's block (b1 h16 8192 x 8192 d128, causal and not)
     against its plain version (output within RING_OUT_RTOL, lse within
     LSE_ATOL), timed as in phase 3, with SDPA and the
     bound. (c) ExpertParallelMoE at Mixtral-8x7B's widths (GELU experts),
     bf16, 4096 tokens over ep 8: within EP_MOE_RTOL of ep 1 at a capacity
     that drops nothing; at capacity factor 1.25 the pairs dropped, forward
     and backward ms, useful TFLOP/s and peak memory beside phase 23 (c).
     (d) a Criteo-shaped CTR model (13 dense and 26 sparse slots, ids
     hashed, Zipf over 2^24 keys, written by MultiSlotDataGenerator in a
     subprocess beside (a) and read by InMemoryDataset on a thread beside
     (e), 32 batches of 4096), one
     SparseTable of dim 16 (adagrad), DeepFM's 400-400-400 MLP on the
     card, steps through PsBatch and PsEmbedding over LocalChannel, then
     over RpcChannel to a server process started with rpc.init_rpc: the
     rows equal over both channels, and within PS_ROW_ATOL of the same
     run on the CPU for PS_ROW_SHARE of the elements after the first
     batch (later batches printed beside); each channel's first two steps
     (PsBatch, then PsEmbedding) redone on the CPU from the card's MLP
     and inputs (and in float64, printed), the pushed rows' gradients
     within PS_GRAD_RTOL and a planted lost sample beyond it; a TheOnePs
     save/load round trip.
  27. the serving mesh (inference/mesh/), on the one card. (a) llama_7b at
     SERVING_DEPTH layers in bf16, built from mesh_spec() by the mesh
     worker's own build_model (weights from seed(0)), serves phase 9's 16
     requests at phase 9's knobs through a single engine and through a
     MeshRouter over an in-process ReplicaPool of one prefill and one
     decode replica sharing the model, each with its own engine, pool and
     decode graphs; the KV hand-off goes through the host (export_kv's
     read-back, pack_record, unpack_record, import_kv's in-place write).
     In bf16, then with int8 and fp8_e4m3 pools: every greedy and sampled
     stream of the mesh equal to the single engine's, every handed-off
     block equal to the prefill pool's blocks at export and to the decode
     pool's after import, no K1-K4 launch; prints tokens/s, TTFT and TPOT
     medians of both, the hand-off's ms (export, wire, import), bytes and
     GB/s, failovers, hedges, slow demotions and kills, and peak memory.
     (b) the same requests through ProcessReplicaPool(transport="socket")
     of two child workers on the card built from the same spec (one
     prefill, one decode): every stream equal to (a)'s bf16 single engine,
     which is worker.build_engine(spec)'s engine; prints the children's
     spawn seconds, the card's free memory after the spawn, tokens/s and
     the hand-off bytes. (c) the chaos drill (tools/chaos_drill.py) with
     its tiny engines on the card: no site ESCAPED, all 31 sites
     drilled, the five compile.* sites of the PIR pipeline
     (compile.shard_prop among them) on a two-op program compiled on the
     card.
     (d) loadgen's chat scenario on the card through --replicas 2
     --disaggregate --check: goodput, TTFT and TPOT p95, and the
     autoscale verdict through tools/autoscale_report.py --check.
  28. the PIR compile pipeline and jit.to_static (pir/, jit/,
     framework/staging.py) on llama_1.3b at full width and depth (24
     layers, hidden 2048, 16 heads of 128, bf16, weights from seed(0)).
     (a) jit.to_static(model.forward) serves a prefill of 4 x 512 tokens:
     logits equal to eager's bit for bit, no fallback, K1 launched
     once a layer a call; prints the capture, verify, pass, cost and
     evaluator seconds, the ops before and after the passes, each pass's
     edits and the CostModel's flops. (b) one training step (b2 s2048)
     through a to_static forward and loss.backward(), then AdamW: the
     loss and every gradient within TS_LOSS_RTOL / TS_GRAD_RTOL of the
     eager step's, K1, K3 and K4 launched once a layer; prints the step's
     ms beside eager's. (c) a hand-written causal einsum-softmax-einsum
     attention at the training attention shape (b8 h16 s2048 d128) is
     captured and becomes one pt.sdpa that launches K1 once, within phase
     3's tolerance of its dense eager version; the unfused rmsnorm(
     attention + residual) * gamma at the prefill shape (b4 h16 s512)
     becomes one pt.sdpa_rms_epilogue that launches K2 once, within phase
     4's tolerance. (d) on a temporary compile_cache_dir, (a)'s program
     cold then warm from a new StaticFunction: the warm call a hit, equal
     to the cold one bit for bit; a flipped byte gives the typed
     CompileCacheCorruptionError, compile_cache_corrupt_total 1 and a
     recompile. (e) a function with one data-dependent branch runs as 2
     staged segments, equal to eager with gradients. (f)
     tools/pipeline_tax.py at its tiny config on the card, its table
     printed (every stage on the one card: the ratio measures serial
     stages).
  29. the PIR sharding passes (pir/shard_prop.py, shard_search.py,
     overlap.py, ops/collectives.py) and the engine through pir_jit. (a)
     llama_1.3b (24 layers, b2 s2048, bf16) trained a step through
     pir_jit(sharding_rules=LLAMA_SHARDING_RULES) under a 2x2 logical
     ProcessMesh ("dp", "mp"): the loss and every gradient equal to the
     same step compiled outside the scope bit for bit, the same K1/K3/K4
     launches (once a layer); prints the values annotated, rules stamped,
     conflicts resolved, sweeps and shard_prop seconds, and the call's ms
     beside the unscoped compile's. (b) its forward under a search scope
     of dp, tp and dp+tp from the rule tables: the decision and each
     candidate's predicted seconds on the H100 rows, the loss equal to
     (a)'s unscoped one. (c) over a one-rank NCCL group, an all-reduce of
     x 4096x8192 @ w 8192x4096 captured after two 4096x4096 products in
     bf16: the overlap pass hoists it (edits >= 1, exposed seconds
     strictly down), the compiled program equal to eager bit for bit;
     the captured and reordered replays' device times printed (one rank
     moves no bytes: no overlap can show on one card). (d), run after
     phase 13 on its model: 4 greedy requests of phase 9's traffic at its
     knobs through pir_jit on a fresh compile cache (the prefill programs
     "miss", the decode "bypass:donate"), again on the same cache (a
     prefill "hit") and with FLAGS_pir off: every stream equal to phase
     9's, no K1-K4 launch; prints the capture and compile seconds, the
     first step's seconds, the prefill chunk's ms compiled and as written
     and the decode tile's beside phase 9's. (e) ReplicaPool(n=2,
     tp=True) against tp=False: equal streams; shard_prop declines in
     every tp program (the reference's scope closes before the lazy
     compiles).
Phases 9, 9b, 13, 27 and 29 (d, e) run llama_7b at SERVING_DEPTH of its 32
layers (full width), after phase 12, which runs at full depth beside phase
8; phase 27 builds it again at that depth.
Each phase's seconds are printed as it ends, then those of phases 1-29.
The last two lines are the kernels' JSON record and
{"ok": true, "device": {...}}. Without a CUDA device it exits non-zero and
prints no result.
"""

from __future__ import annotations

import copy
import gc
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
from pathlib import Path

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

import paddle_tpu_torch as pt
from paddle_tpu_torch import generation
from paddle_tpu_torch import optimizer
from paddle_tpu_torch.models import build_scanned_llama
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.incubate.nn import functional as IF
from paddle_tpu_torch import inference, jit
from paddle_tpu_torch.inference import (ContinuousBatchingEngine,
                                        SLOScheduler, demo_store_for_engine)
from paddle_tpu_torch.inference import loadgen
from paddle_tpu_torch.inference.mesh import (MeshRouter, ProcessReplicaPool,
                                             ReplicaPool, worker)
from paddle_tpu_torch.inference.mesh import router as mesh_router
from paddle_tpu_torch.inference.scheduler import level_index
from paddle_tpu_torch.profiler.phases import get_phase_accountant
from paddle_tpu_torch.observability.quantiles import quantile_from_cumulative
from paddle_tpu_torch.ops import _build
from paddle_tpu_torch.ops import attention_router as ar
from paddle_tpu_torch.ops import flash_attention as fa
from paddle_tpu_torch.nn import Dropout, quant
from paddle_tpu_torch.nn import functional as PF
from paddle_tpu_torch.tools import (bench_decode, profile_serving,
                                    profile_train, train_bert, train_llama,
                                    train_resnet)
from paddle_tpu_torch.vision import ops as V
from paddle_tpu_torch import amp, callbacks, io as pio, metric
from paddle_tpu_torch.vision import datasets as VD
from paddle_tpu_torch.vision import models as VM
from paddle_tpu_torch.vision import transforms as VT

# published peaks of one H100 SXM (NVIDIA data sheet, dense): HBM bytes/s
# and bf16 tensor-core FLOP/s
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12

# K1 against its plain version in bf16: out within one or two bf16
# roundings (P is rounded to bf16 before P V at a different place in each:
# unnormalized in the kernel, normalized in the plain version), lse from f32
# scores summed in another order
OUT_ATOL = OUT_RTOL = 2e-2
LSE_ATOL = 1e-3
# K2 against its plain version: the attention output before the epilogue
# differs as K1's does (above), and the epilogue multiplies it by
# rsqrt(mean(h^2)) * gamma, about |gamma| for h = attn + a unit-variance
# residual, and the kernel adds the residual to the f32 attention output
# while the unfused composition of phase 9 adds it to the bf16-rounded one:
# so |err| <= K2_ATOL * max|gamma| + K2_RTOL * |ref|
K2_ATOL = 3e-2
K2_RTOL = 2e-2
RMS_EPS = 1e-6
# K3/K4 against the plain backward in bf16 (or fp16), each gradient
# relative to its largest magnitude: both round P and dS to bf16 at the
# same points, but from f32 sums taken in another order, so a rounding may
# fall the other way; the gradients are rounded to bf16 (a relative step
# of 2^-8)
BWD_RTOL = 2e-2
# tiny llama in bf16 on the card against the same weights in f32 on the CPU
TINY_LOGITS_ATOL = 0.1
# the tiny training step, bf16 on the card against f32 on the CPU: every
# activation and gradient is rounded to bf16 at each op through two layers
# and back. Loss relative to its value; each gradient and moment relative
# to its largest magnitude; parameters after one AdamW step within 2 lr
# (the first update is at most lr in size, about lr * sign(grad), and the
# sign of a gradient near 0 may differ) plus the bf16 rounding of the
# updated parameter
TINY_LOSS_RTOL = 1e-2
TINY_GRAD_RTOL = 5e-2
TINY_LR = 1e-3

PREFILL = dict(b=4, h=32, kvh=32, sq=512, sk=512, d=128, causal=True)
# the training slice's attention: llama_1.3b at batch 8, sequence 2048
TRAIN_ATTN = dict(b=8, h=16, kvh=16, sq=2048, sk=2048, d=128, causal=True)
# BERT-base pretraining's attention (bench.py:299): batch 32, sequence 512,
# 12 heads of 64, no mask and no causal flag
BERT_ATTN = dict(b=32, h=12, kvh=12, sq=512, sk=512, d=64, causal=False)
# Transformer-base's attention in phase 20 (the encoder's self-attention
# and the cross-attention): batch 32, sequence 128, 8 heads of 64, no mask
# and no causal flag
MT_ATTN = dict(b=32, h=8, kvh=8, sq=128, sk=128, d=64, causal=False)
# ViT-B/16's attention in phase 21: 64 images, 12 heads of 64 over 197
# tokens (196 patches and the class token), no mask, not causal; 197 is no
# multiple of any tile, so the padded rows must never be written
VIT_ATTN = dict(b=64, h=12, kvh=12, sq=197, sk=197, d=64, causal=False)
# bench.py's decode leg's prefill attention (phase 17): batch 8, prompt 128,
# 16 heads of 128
DECODE_PREFILL = dict(b=8, h=16, kvh=16, sq=128, sk=128, d=128, causal=True)
# the edges of the forward kernel's 128-row block and 128-key ring tiles
# (two slots at d128, three at d64): one tile, one row short of and one
# past a block, a single query row over three key tiles, two query blocks
# over eight key tiles, and three query blocks over one key tile whose first
# 200 rows admit no key (causal, sq > sk)
EDGES = [(64, 64, True), (127, 127, True), (129, 129, True), (1, 300, False),
         (130, 1000, True), (300, 100, True)]
FWD_EDGE_CASES = (
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128) for sq, sk, c in EDGES]
    + [dict(b=2, h=32, kvh=4, sq=256, sk=256, d=64, causal=True),    # GQA 8:1
       dict(TRAIN_ATTN, dtype=torch.float16)])
BASE_CASES = (
    # the reference's CASES (tests/test_flash_attention.py:41), b2 h4
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128)
     for sq, sk, c in [(256, 256, False), (256, 256, True),
                       (200, 200, True), (384, 384, True),
                       (520, 520, True), (128, 320, True),
                       (100, 260, False)]]
    + [dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True),   # GQA
       dict(b=2, h=8, kvh=8, sq=256, sk=256, d=96, causal=True),     # pad
       PREFILL, TRAIN_ATTN, BERT_ATTN, MT_ATTN, VIT_ATTN])
K1_CASES = BASE_CASES + FWD_EDGE_CASES + [DECODE_PREFILL]
K2_CASES = (
    [dict(b=2, h=4, kvh=4, sq=sq, sk=sk, d=d, causal=c)
     for d in (64, 128)
     for sq, sk, c in [(256, 256, True), (200, 200, True), (520, 520, True),
                       (128, 320, True), (100, 260, False)]]
    + [dict(b=2, h=4, kvh=2, sq=256, sk=256, d=64, causal=True),     # GQA
       dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True),   # GQA
       dict(b=2, h=8, kvh=8, sq=256, sk=256, d=96, causal=True),     # pad
       dict(b=2, h=4, kvh=4, sq=200, sk=200, d=128, causal=True,
            dtype=torch.float16),
       PREFILL, TRAIN_ATTN]
    + FWD_EDGE_CASES)
# K3/K4 at K1's cases, and also in fp16 at a GQA case and a padded case
K34_CASES = BASE_CASES + FWD_EDGE_CASES + (
    [dict(b=2, h=32, kvh=8, sq=512, sk=512, d=128, causal=True,
          dtype=torch.float16),
     dict(b=2, h=4, kvh=4, sq=200, sk=200, d=64, causal=True,
          dtype=torch.float16)])

# the continuous-batching engine's phase: llama_7b through
# ContinuousBatchingEngine at these knobs, serving ENGINE_REQUESTS requests
# of ENGINE_NEW tokens each, prompts of 64-1536 tokens from RandomState(0);
# the first half is added before the first step, the rest after the third
ENGINE = dict(max_batch=8, block_size=16, max_blocks_per_seq=128,
              num_blocks=1040, prefill_buckets=(64, 128, 256, 512),
              prefill_chunk=512)
ENGINE_REQUESTS = 16
ENGINE_NEW = 64
ENGINE_SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
ENGINE_SAMPLED_AT = (2, 5, 10, 13)      # 4 sampled requests, 2 a wave
# the engine's first-chunk logits against the dense model forward, both in
# bf16 on the card: the engine's paged attention takes f32 scores over the
# bf16 pool, the forward takes K1 or dense attention, and every product and
# residual add of every layer (SERVING_DEPTH of llama_7b's) rounds to bf16
# on both sides in another order, so each logit may differ by a few bf16
# steps of the largest logit (2^-8 relative): |err| <= ENGINE_LOGITS_RTOL *
# max|logit|. Measured on an H100: 1.28e-2 at 8 layers, 1.75e-2 at 32
ENGINE_LOGITS_RTOL = 5e-2

# the engine-knobs phase (after phase 9), on phase 9's model and knobs:
# speculative decode at depth 2 over 3-grams; a second mix of 8 greedy
# requests whose 512-token prompts tile one 5-token motif (bench.py's
# decode A/B mix), 64 new tokens each
KNOB_SPEC = dict(speculative_decode=True, draft_depth=2, draft_ngram=3)
MOTIF_REQUESTS, MOTIF_PROMPT, MOTIF_NEW = 8, 512, 64
# quantized pools at the bf16 pool's bytes must hold this many times its
# blocks (int8: 4,096 payload + 64 scale bytes a token and head set,
# against 8,192)
QUANT_MIN_BLOCKS = 1.9
# each prompt's first-chunk logits with a quantized pool against the bf16
# pool's, relative to the largest |logit|. Quantization error of a stored
# K or V element: int8 rounds to 1/254 of its (token, head) absmax, about
# the size of a bf16 rounding of a large element, so int8 takes phase 9's
# tolerance for a bf16 pool against the dense forward; fp8 e4m3 keeps 3
# mantissa bits, a relative step of 2^-3 (16 times bf16's 2^-7), so its
# tolerance is four times int8's (the error of sums of many such
# roundings grows as the square root of their count)
QUANT_LOGITS_RTOL = {"int8": ENGINE_LOGITS_RTOL,
                     "fp8_e4m3": 4 * ENGINE_LOGITS_RTOL}
# the kv-dequant degradation is forced on this decode phase's hit of the
# serve.kv_dequant site (FLAGS_fault_injection)
KV_DEQUANT_FAULT = "serve.kv_dequant:6:TimeoutError"
# adapters: demo_store_for_engine with 4 adapters of rank 8 in 8 slots.
# Its default scale 0.5 is sized for hidden 64; at hidden 4096 the delta
# x A B would be about 35 times the base projection, so the factors here
# are scaled to 0.05, a delta of the base projection's order
ADAPTERS = dict(names=["ad0", "ad1", "ad2", "ad3"], rank=8, n_slots=8,
                scale=0.05)
# prefix cache: 8 requests share a 1,024-token system prefix, with tails
# of 64-256 tokens; one request is exactly the prefix. The engine prefills
# at one width (512): a block-aligned full match re-runs only the last
# prompt position, and in a chunk of another width the bf16 products would
# round it differently from the cache-off run; at one width every
# position's forward is the same whichever chunk holds it
PREFIX_LEN, PREFIX_TAILS = 1024, (64, 96, 128, 160, 192, 224, 256, 0)
PREFIX_BUCKETS = (512,)
# load generation (phase 12): every scenario for this many seconds of
# schedule at phase 9's knobs with a bounded admission queue (overload is
# shed by backpressure, as the reference harness's engine sheds it), then
# chat at each sweep rate without draining (5 requests/s is about half
# the engine's saturated goodput_rps on the H100, 10 is about all of it,
# 40 sheds);
# the floors check_report takes for the shared_prefix and multi_adapter
# scenarios are the reference CLI's defaults. A program's measured over
# predicted cost must lie in COST_RATIO_BAND, the band the CPU tests hold
# a prediction across prefill widths to
LOADGEN_SECONDS = 6.0
LOADGEN_QUEUE = 64
SWEEP_RATES, SWEEP_SECONDS = (5.0, 10.0, 40.0), 6.0
COST_RATIO_BAND = (0.2, 5.0)
MIN_PREFIX_HIT_RATE, MIN_ADAPTER_LOADS = 0.5, 1
# the predictor phase (13): the saved llama_7b runs phase 8's prompts; its
# logits against the model's eager forward, both bf16 on the card through
# the same kernels, relative to the largest |logit|: the exported program
# runs the forward's aten ops, so the two should agree to the bit, and the
# bound is phase 9's bf16 tolerance for two forwards that round in another
# order
PREDICTOR_SPEC = ([4, 512], "int64")
PREDICTOR_LOGITS_RTOL = ENGINE_LOGITS_RTOL

# the BERT phase: BERT-base's first training step under the routed
# attention (K1, K3/K4) against the same step under the dense backend, the
# same weights and data. Only attention differs, by a bf16 rounding here
# and there: at this initialisation the loss is about ln(30522) = 10.3 and
# such roundings move it by about 1e-5 of that
BERT_LOSS_RTOL = 1e-3
# the GPT phase: gpt3_1p3b greedy through the recompute path, GPT_BATCH
# prompts of GPT_PROMPT tokens from RandomState(0), GPT_NEW new tokens; the
# last forward's logits under the routed backend against the dense one, by
# the engine's bf16 bound relative to the largest |logit|
GPT_BATCH, GPT_PROMPT, GPT_NEW = 4, 128, 32
GPT_LOGITS_RTOL = ENGINE_LOGITS_RTOL


# the ResNet phase: a float32 ResNet-50 forward at b4 224x224 on the card
# (cuDNN, TF32 off) against the same weights and images on the CPU, the
# same math summed in other orders, relative to the largest |logit|; and
# the bf16 step's first loss against the float32 model's on the same
# batch: bf16 roundings through 53 batch norms move the logits by 2-3% of
# the largest |logit| (tests/test_torch_vision.py, resnet18), and a loss
# of about ln(1000) by at most twice that
RESNET_F32_RTOL = 1e-4
RESNET_BF16_LOSS_RTOL = 5e-2
RESNET_CHECK_BATCH = 4
# the ResNet trace's kernel classes ahead of profile_train's: cuDNN's
# convolutions, the pools, and the layout transposes cuDNN adds around
# NCHW bf16 convolutions
RESNET_CLASSES = (("convolutions (cuDNN)", ("conv", "fprop", "dgrad",
                                            "wgrad", "implicit", "cudnn")),
                  ("pooling", ("pool",)),
                  ("layout transposes", ("nchwtonhwc", "nhwctonchw")))

# the vision-zoo phase: the flagship of every family but MobileNetV2's
# (which trains 1 + 8 steps) trained 1 + 2 steps; their float32 outputs
# on the card against the CPU's at ZOO_CHECK_BATCH. The new ops on the
# card against the CPU: float32 (TF32 off) results are the same math
# summed in other orders, as RESNET_F32_RTOL's; a bf16 transposed
# convolution rounds its output to bf16 (2^-9 relative) after cuDNN's
# float32 accumulation over 256 x 4 products, against the CPU's float32
# result of the same bf16 inputs, relative to the largest |value|
ZOO_FLAGSHIPS = ("mobilenet_v1", "mobilenet_v3_small", "mobilenet_v3_large",
                 "densenet121", "alexnet", "squeezenet1_1",
                 "shufflenet_v2_x1_0", "googlenet", "inception_v3")
ZOO_STEPS = 2
ZOO_CHECK_BATCH = 2
ZOO_OPS_F32_RTOL = 1e-4
ZOO_OPS_BF16_RTOL = 1e-2
ZOO_DEPTHWISE = "depthwise convolutions"

# phase 19, the high-level API. (a) ResNet-50 on the synthetic Flowers-102
# through Model.fit under O1: batch 64 of 224 x 224 (ImageNet's mean and
# std), 1 warm-up + 8 timed iterations, 4 loader threads. Its first
# train_batch's loss on the card against the CPU port's under the same O1
# on the same weights and batch: both round each of the 53 convolutions'
# outputs to bf16, in other orders and algorithms, so each lies within
# RESNET_BF16_LOSS_RTOL / 2 of a float32 loss, and the two within
# RESNET_BF16_LOSS_RTOL of each other. (b) BERT-base with PaddleNLP's
# optimizer, 1 + 4 steps: the clip's float32 global norm on the card
# against a float64 sum of the same bf16 gradients' squares, within
# HAPI_CLIP_NORM_RTOL (float32 sums over 1.1e8 squares in a tree of
# depth ~27, a few units of 2^-24 each). (c) LeNet on the synthetic MNIST
# as examples/train_lenet_mnist.py runs it: one epoch, then evaluate;
# the accuracy within HAPI_LENET_ACC_ATOL of the CPU port's run of the
# same weights and shuffles (one or two of 2048 test images, and the
# float32 steps part in the last digits)
HAPI_BATCH = 64
HAPI_ITERS = 9
HAPI_WORKERS = 4
HAPI_MEAN = [0.485, 0.456, 0.406]
HAPI_STD = [0.229, 0.224, 0.225]
HAPI_BERT_STEPS = 4
HAPI_CLIP_NORM_RTOL = 1e-5
HAPI_LENET_ACC_ATOL = 0.02

# phase 20, machine translation. (a) Transformer-base (Vaswani et al.
# 2017, Table 3 "base"): one shared 37,000-token vocabulary, b32 x 128
# source and target tokens a step (§5.1's 25,000 a side over 8 GPUs is
# about 3,125 a card), residual dropout 0.1, label smoothing 0.1,
# Adam(0.9, 0.98, 1e-9) under NoamDecay(512, 4000), bf16, 1 + 8 steps.
# Its float32 twin at 2 + 2 layers, dropout off, TF32 off, on the card and
# the CPU with the same weights and batch: the same float32 math summed in
# other orders, over 4,096 tokens and a 37,000-way softmax; the loss,
# about ln(37000) = 10.5, moves by a few float32 roundings of it, and the
# gradient norm, a sum over 4,096 tokens' contributions per weight, by a
# few more
MT_VOCAB, MT_BATCH, MT_SEQ = 37000, 32, 128
MT_DROPOUT, MT_LABEL_SMOOTHING, MT_WARMUP, MT_STEPS = 0.1, 0.1, 4000, 8
MT_TWIN_LOSS_RTOL, MT_TWIN_GRAD_RTOL = 1e-4, 1e-3
MT_BOS, MT_EOS = 1, 2
# (b) tensorflow/nmt's standard_hparams/iwslt15.json (IWSLT'15 en-vi):
# vocabularies 17,191 and 7,709, 512 units, dropout 0.2, batch 128,
# lengths 50, SGD at lr 1.0 with max_gradient_norm 5, float32; 1 + 4
# training steps, then 32 sentences decoded at beam 10 for at most 100
# steps (infer_batch_size 32, beam_width 10). With dropout off the card's
# predicted_ids are held to the CPU's: the CPU replays the card's decode
# with the card's tokens, parents and running scores forced at every step
# (ReplayBeamSearch), so that each step is compared with one step's
# rounding. At every step the card's top totals are within NMT_SCORE_ATOL
# of the CPU's totals of the same extensions: the two sums may round one
# float32 ulp apart (6.1e-5 below |score| 1024; 100 steps near uniform
# over 7,709 tokens sum to about -895), plus the rounding of the step's
# log-probability. Where the card picked other extensions than the CPU's
# own top-k, the CPU's sorted totals of the card's picks are within
# NMT_TIE_ATOL of its own top-k totals: a near-tie in the CPU's ranking.
# The CPU's own free decode is reported beside it, with the gap at its
# first differing step (its running scores are its own there, so the gap
# holds every earlier step's rounding too; the replay is the check)
NMT_SRC_VOCAB, NMT_TGT_VOCAB, NMT_HIDDEN, NMT_DROPOUT = 17191, 7709, 512, 0.2
NMT_BATCH, NMT_LEN, NMT_STEPS = 128, 50, 4
NMT_DECODE_BATCH, NMT_BEAM, NMT_MAX_STEPS = 32, 10, 100
NMT_SCORE_ATOL, NMT_TIE_ATOL = 1e-4, 1e-4

# phases 9, 9b, 13 and 27 run llama_7b at this depth (full width), phases
# 8 and 12 at its full 32 layers. Phases 9, 9b and 13 take about 8 s a
# layer on an H100 at 700 W (101-120 s at 8 layers, 308.7 s at 32). At 16
# layers the script took 873.1-999.3 s of command; at 12, with phase 28,
# 1,193.0 s on a slow host (phases 1-27 1,030.2 s there), so the depth is
# 8, which keeps the script well below its 1,200 s limit
SERVING_DEPTH = 8
# phase 9's engine numbers, which phase 29 (d) prints its own beside
PHASE9 = {}

# the card's name and power limit as nvidia-smi gives them (phase 1)
CARD = "not read"
ROOT = os.path.dirname(os.path.abspath(__file__))


def log(*args):
    print(*args, flush=True)


def time_ms(fn, reps=25, warmup=3):
    """Median of `reps` single-call times on CUDA events, after warm-up:
    each call's host work (tensor maps, ctypes, allocation) can show."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, calls=20, warmup=3):
    """Device time of one call: `calls` back-to-back calls captured in one
    CUDA graph and replayed between one pair of CUDA events, so no host
    work (tensor-map encoding, ctypes, allocation) lies between them. A
    call that cannot be captured raises."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def bound_ms(nbytes, flops):
    """Least time for `nbytes` moved and `flops` done: the larger of bytes
    over the HBM rate and FLOPs over the bf16 peak, and which it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def attn_pairs(sq, sk, causal):
    """(row, key) pairs a head computes: those the causal mask admits."""
    if not causal:
        return sq * sk
    rows = np.arange(sq)
    return int(np.clip(rows + (sk - sq) + 1, 0, sk).sum())


def k1_bound_ms(b, h, kvh, sq, sk, d, causal, itemsize=2, **_):
    """One K1 call: q, k, v read once, out and lse written once; two
    products (Q K^T, P V) of 2 d FLOP a pair."""
    nbytes = itemsize * d * (2 * b * h * sq + 2 * b * kvh * sk) + 4 * b * h * sq
    return bound_ms(nbytes, 2 * 2 * d * attn_pairs(sq, sk, causal) * b * h)


def k2_bound_ms(b, h, kvh, sq, sk, d, causal, itemsize=2, **_):
    """One K2 call: K1's bytes plus the residual read and gamma (f32) read
    once; K1's two products. The epilogue's f32 elementwise work (about 6
    operations an output element: 0.75 us at the prefill shape at the
    67 TFLOP/s f32 rate) is left out, as K1's bound leaves out the
    softmax."""
    nbytes = (itemsize * d * (3 * b * h * sq + 2 * b * kvh * sk)
              + 4 * b * h * sq + 4 * d)
    return bound_ms(nbytes, 2 * 2 * d * attn_pairs(sq, sk, causal) * b * h)


def bwd_flops(kernel, b, h, sq, sk, d, causal, **_):
    """FLOPs of one K3 call (three products: Q K^T, dO V^T, dS K) or one K4
    call (four: Q K^T, dO V^T, P^T dO, dS^T Q), 2 d a (row, key) pair
    each."""
    products = 3 if kernel == "dq" else 4
    return products * 2 * d * attn_pairs(sq, sk, causal) * b * h


def bwd_bound_ms(kernel, b, h, kvh, sq, sk, d, causal, itemsize=2):
    """One K3 call (dq written) or one K4 call (dk and dv written); each
    reads q, dO, k, v, lse and delta once."""
    nbytes = (itemsize * d * (2 * b * h * sq + 2 * b * kvh * sk)
              + 8 * b * h * sq)
    if kernel == "dq":
        nbytes += itemsize * d * b * h * sq
    else:
        nbytes += 2 * itemsize * d * b * kvh * sk
    return bound_ms(nbytes, bwd_flops(kernel, b, h, sq, sk, d, causal))


def library_attention(q, k, v, causal):
    """torch's own fused attention on (b, h, s, d), the yardstick: never
    called by the port."""
    sq, sk = q.shape[2], k.shape[2]
    if not causal:
        return torch.nn.functional.scaled_dot_product_attention(q, k, v)
    if sq == sk:
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, is_causal=True)
    from torch.nn.attention.bias import causal_lower_right
    return torch.nn.functional.scaled_dot_product_attention(
        q, k, v, attn_mask=causal_lower_right(sq, sk))


def library_attention_bwd(q, k, v, g, causal):
    """torch's own flash-attention backward on (b, h, s, d), dq, dk and dv
    in one call, the yardstick of K3 and K4 together: never called by the
    port. Returns a function that runs the backward alone."""
    fwd = torch.ops.aten._scaled_dot_product_flash_attention(
        q, k, v, 0.0, causal, False)
    out, lse, cum_q, cum_k, max_q, max_k, seed, offset = fwd[:8]
    return lambda: torch.ops.aten._scaled_dot_product_flash_attention_backward(
        g, q, k, v, out, lse, cum_q, cum_k, max_q, max_k, 0.0, causal, seed,
        offset)


def phase_device():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device; the port's smoke run needs one")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    global CARD
    CARD = smi.stdout.strip().splitlines()[0]
    log("nvidia-smi:", CARD)
    log("torch", torch.__version__, "cuda", torch.version.cuda,
        "device", torch.cuda.get_device_name(0))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("tf32: off for float32 matmul and cuDNN")


def phase_build():
    """Build the kernels; fail if ptxas spills in any instantiation of the
    forward or backward kernels or ignores a setmaxnreg (warning C7508)."""
    t0 = time.perf_counter()
    _build.library()
    log(f"build: kernel library ready in {time.perf_counter() - t0:.2f} s")
    faults = []
    for entry in _build.build_log:
        function = ""
        for line in entry.splitlines():
            if "C7508" in line or ("warning" in line
                                   and "setmaxnreg" in line):
                faults.append(line.strip())
            if "Compiling entry function" in line or \
                    "Function properties for" in line:
                function = line.split()[-1] if "properties" in line \
                    else line.split("'")[1]
            if "registers" in line or "spill" in line:
                log("  nvcc:", line.strip())
            spills = [int(n) for n in re.findall(r"(\d+) bytes spill", line)]
            if re.search(r"flash_(fwd|bwd_dq|bwd_dkv)_kernel", function) \
                    and any(spills):
                faults.append(f"{function}: {line.strip()}")
    if faults:
        sys.exit("chip_smoke: a flash kernel spills or loses its "
                 "setmaxnreg:\n" + "\n".join(faults))
    log("build: no spills and no C7508 in the forward and backward kernels")


def case_inputs(case, gen, with_grad=False):
    """Random (b, s, heads, d) q, k, v (and dO) for a case, in its dtype
    (bf16 by default), and each as (BH, S, D): padded to the kernels' head
    dim, and as it is for the plain versions."""
    b, h, kvh, sq, sk, d = (case[x] for x in ("b", "h", "kvh", "sq", "sk",
                                              "d"))

    def rand(s, heads):
        return torch.randn(b, s, heads, d, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)
    dtype = case.get("dtype", torch.bfloat16)
    xs = [rand(sq, h), rand(sk, kvh), rand(sk, kvh)]
    if with_grad:
        xs.append(rand(sq, h))
    pad = (64 if d <= 64 else 128) - d

    return (xs, [bhsd(x, pad) for x in xs], [bhsd(x, 0) for x in xs])


def bhsd(x, pad):
    """(b, s, heads, d) -> (b * heads, s, d + pad), zero-padded."""
    x = torch.nn.functional.pad(x, (0, pad)) if pad else x
    return x.transpose(1, 2).reshape(-1, x.shape[1], x.shape[3]) \
        .contiguous()


def live_rows(case):
    """(sq,) bool on the card: the query rows that admit at least one key.
    Under the bottom-right causal mask with sq > sk the first sq - sk rows
    admit none; their values are undefined and not compared."""
    rows = torch.arange(case["sq"], device="cuda")
    if not case["causal"]:
        return torch.ones_like(rows, dtype=torch.bool)
    return rows >= case["sq"] - case["sk"]


def case_name(case):
    dtype = str(case.get("dtype", torch.bfloat16)).replace("torch.", "")
    return (f"b{case['b']} h{case['h']}/kv{case['kvh']} sq{case['sq']} "
            f"sk{case['sk']} d{case['d']} causal={case['causal']} {dtype}")


def phase_k1():
    """K1 vs its plain version at every case; returns the records of the
    prefill, training, BERT, decode-prefill and Transformer-base shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = {}
    for case in K1_CASES:
        h, kvh, d, causal = case["h"], case["kvh"], case["d"], case["causal"]
        (q, k, v), (qk, kk, vk), (qp, kp, vp) = case_inputs(case, gen)
        scale = 1.0 / d ** 0.5
        rep = h // kvh
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa._flash_fwd_bhsd_plain(qp, kp, vp, causal,
                                                        scale, rep)
            out = out[..., :d].float()
            finite = bool(torch.isfinite(out).all() and
                          torch.isfinite(lse).all())
            live = live_rows(case)
            out, ref_out = out[:, live], ref_out[:, live].float()
            err_out = (out - ref_out).abs().max().item()
            err_lse = (lse[:, live] - ref_lse[:, live]).abs().max().item()
            ok = (finite and err_lse <= LSE_ATOL
                  and torch.allclose(out, ref_out, atol=OUT_ATOL,
                                     rtol=OUT_RTOL))
            del ref_out, ref_lse
            kernel = lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal, scale,
                                                rep)
            call_ms, ms = time_ms(kernel), device_ms(kernel)
            plain_ms = time_ms(lambda: fa._flash_fwd_bhsd_plain(
                qp, kp, vp, causal, scale, rep))
            ql = q.transpose(1, 2).contiguous()
            kl = k.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            vl = v.repeat_interleave(rep, dim=2).transpose(1, 2).contiguous()
            library = lambda: library_attention(ql, kl, vl, causal)
            library_call_ms, library_ms = time_ms(library), device_ms(library)
        bound, bound_by = k1_bound_ms(**case)
        log(f"K1 {case_name(case)}: "
            f"max|out err| {err_out:.3e} max|lse err| {err_lse:.3e} "
            f"(tol out {OUT_ATOL}+{OUT_RTOL}*|ref|, lse {LSE_ATOL}) "
            f"kernel {ms:.4f} ms back to back ({call_ms:.4f} single call) "
            f"plain {plain_ms:.4f} ms sdpa {library_ms:.4f} ms back to "
            f"back ({library_call_ms:.4f} single call) bound "
            f"{bound * 1e3:.2f} us ({bound_by}) finite: {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K1 disagrees with its plain version at "
                     f"{case}")
        for name, shape in (("prefill", PREFILL), ("train", TRAIN_ATTN),
                            ("bert", BERT_ATTN), ("decode", DECODE_PREFILL),
                            ("mt", MT_ATTN), ("vit", VIT_ATTN)):
            if case is shape:
                records[name] = dict(
                    max_abs_err=max(err_out, err_lse), ms=ms,
                    plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                    library_ms=library_ms)
    return records


def epilogue_inputs(case, seed):
    """Residual (b, sq, h, d) in the case's dtype and gamma (d,) f32 on the
    card, from a seeded numpy draw."""
    rs = np.random.RandomState(seed)
    dtype = case.get("dtype", torch.bfloat16)
    res = torch.as_tensor(rs.randn(case["b"], case["sq"], case["h"],
                                   case["d"]).astype(np.float32),
                          device="cuda").to(dtype)
    w = torch.as_tensor(rs.randn(case["d"]).astype(np.float32),
                        device="cuda")
    return res, w


def torch_epilogue(att, res, w):
    """incubate's unfused epilogue: rmsnorm(att + res) * w over the last
    dim, in att's dtype."""
    return IF._rms_epilogue(att, res, w, RMS_EPS)


def phase_k2():
    """K2 vs its plain version at every case, its lse against K1's; returns
    the records of the prefill and training shapes."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    records = {}
    for i, case in enumerate(K2_CASES):
        h, kvh, d, causal = case["h"], case["kvh"], case["d"], case["causal"]
        _, (qk, kk, vk), (qp, kp, vp) = case_inputs(case, gen)
        res, w = epilogue_inputs(case, 100 + i)
        dp = qk.shape[2]
        rk = bhsd(res, dp - d)
        rp = bhsd(res, 0)
        wk = torch.nn.functional.pad(w, (0, dp - d))
        scale = 1.0 / d ** 0.5
        rep = h // kvh
        kw = dict(residual=rk, rms_weight=wk, rms_eps=RMS_EPS, rms_d=d)
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep,
                                          **kw)
            _, k1_lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa._flash_fwd_bhsd_plain(
                qp, kp, vp, causal, scale, rep, rp, w, RMS_EPS, d)
            out = out[..., :d].float()
            finite = bool(torch.isfinite(out).all() and
                          torch.isfinite(lse).all())
            live = live_rows(case)
            out, ref_out = out[:, live], ref_out[:, live].float()
            gmax = w.abs().max().item()
            err_out = (out - ref_out).abs().max().item()
            err_lse = (lse[:, live] - ref_lse[:, live]).abs().max().item()
            ok = (finite and bool(((out - ref_out).abs() <= K2_ATOL * gmax
                                   + K2_RTOL * ref_out.abs()).all())
                  and err_lse <= LSE_ATOL and torch.equal(lse, k1_lse))
            del ref_out, ref_lse
            timed = case is PREFILL or case is TRAIN_ATTN
            if timed:
                kernel = lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal,
                                                    scale, rep, **kw)
                k1 = lambda: fa._flash_fwd_bhsd(qk, kk, vk, causal, scale,
                                                rep)
                call_ms, ms = time_ms(kernel), device_ms(kernel)
                plain_ms = time_ms(lambda: fa._flash_fwd_bhsd_plain(
                    qp, kp, vp, causal, scale, rep, rp, w, RMS_EPS, d),
                    reps=5)
                k1_call_ms, k1_ms = time_ms(k1), device_ms(k1)
                unfused_ms = device_ms(lambda: torch_epilogue(k1()[0], rk,
                                                              wk))
        bound, bound_by = k2_bound_ms(**case)
        log(f"K2 {case_name(case)}: max|out err| {err_out:.3e} "
            f"(tol {K2_ATOL}*max|gamma| {gmax:.2f} + {K2_RTOL}*|ref|) "
            f"max|lse err| {err_lse:.3e} (tol {LSE_ATOL}), lse equal to "
            f"K1's: {torch.equal(lse, k1_lse)}, finite: {finite} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K2 disagrees with its plain version at "
                     f"{case}")
        if not timed:
            continue
        log(f"  K2 kernel {ms:.4f} ms back to back ({call_ms:.4f} single "
            f"call), bound {bound:.4f} ms ({bound_by}), plain "
            f"{plain_ms:.4f} ms; yardsticks back to back: K1 alone "
            f"{k1_ms:.4f} ms ({k1_call_ms:.4f} single call; K2/K1 "
            f"{ms / k1_ms:.3f}), K1 + torch epilogue {unfused_ms:.4f} ms")
        records["prefill" if case is PREFILL else "train"] = dict(
            max_abs_err=max(err_out, err_lse), ms=ms, plain_ms=plain_ms,
            bound_ms=bound, bound_by=bound_by, library_ms=None)
    return records


def phase_k34():
    """K3 and K4 vs the plain backward at every case, on the kernel
    forward's out and lse; dQ, dK and dV repeated bit for bit; times at the
    Llama training shape, BERT's and Transformer-base's. Returns the
    records of K3 and K4 there: {"train" | "bert" | "mt": {"dq" | "dkv":
    record}}."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    records = {}
    for case in K34_CASES:
        h, kvh, d, causal = case["h"], case["kvh"], case["d"], case["causal"]
        xs, (qk, kk, vk, gk), (qp, kp, vp, gp) = case_inputs(case, gen, True)
        # rows that admit no key (causal sq > sk) are undefined in the
        # forward; with dO zero there they add nothing in either version
        dead = ~live_rows(case)
        gk[:, dead] = 0
        gp[:, dead] = 0
        scale = 1.0 / d ** 0.5
        rep = h // kvh
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qk, kk, vk, causal, scale, rep)
            got = fa._flash_bwd_bhsd(qk, kk, vk, out, lse, gk, causal, scale,
                                     rep)
            again = fa._flash_bwd_bhsd(qk, kk, vk, out, lse, gk, causal,
                                       scale, rep)
            torch.cuda.synchronize()
            ref = fa._flash_bwd_bhsd_plain(
                qp, kp, vp, out[..., :d].contiguous(), lse, gp, causal, scale,
                rep)
            abs_errs, errs = [], []
            for x, r in zip(got, ref):
                r = r.float()
                abs_errs.append((x[..., :d].float() - r).abs().max().item())
                errs.append(abs_errs[-1] / r.abs().max().item())
            del ref
            finite = all(bool(torch.isfinite(x).all()) for x in got)
            repeat = all(torch.equal(x, y) for x, y in zip(got, again))
        ok = finite and all(e <= BWD_RTOL for e in errs) and repeat
        log(f"K3/K4 {case_name(case)}: max|err|/max|ref| dq {errs[0]:.3e} "
            f"dk {errs[1]:.3e} dv {errs[2]:.3e} (tol {BWD_RTOL}), finite: "
            f"{finite}, dq/dk/dv repeat bitwise: {repeat} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit(f"chip_smoke: K3/K4 disagree with the plain backward "
                     f"or do not repeat at {case}")
        timed = {id(TRAIN_ATTN): "train", id(BERT_ATTN): "bert",
                 id(MT_ATTN): "mt", id(VIT_ATTN): "vit"}
        if id(case) not in timed:
            continue
        shape = records.setdefault(timed[id(case)], {})
        with torch.inference_mode():
            # the wrapper's delta pass, as _flash_bwd_bhsd takes it
            delta_fn = lambda: (gk.float() * out.float()).sum(-1)
            delta = delta_fn()
            args = (qk, kk, vk, gk, lse, delta, causal, scale, rep)
            dq_ms = device_ms(lambda: fa._flash_bwd_dq_cuda(*args))
            dkv_ms = device_ms(lambda: fa._flash_bwd_dkv_cuda(*args))
            delta_ms = device_ms(delta_fn)
            plain_ms = time_ms(lambda: fa._flash_bwd_bhsd_plain(
                qp, kp, vp, out, lse, gp, causal, scale, rep), reps=5)
            lib = library_attention_bwd(
                *(x.transpose(1, 2).contiguous() for x in xs[:3]),
                xs[3].transpose(1, 2).contiguous(), causal)
            library_ms = device_ms(lib)
        for name, ms, err in (("dq", dq_ms, abs_errs[0]),
                              ("dkv", dkv_ms, max(abs_errs[1:]))):
            bound, bound_by = bwd_bound_ms(name, **case)
            shape[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                               bound_ms=bound, bound_by=bound_by,
                               library_ms=library_ms)
            tflops = bwd_flops(name, **case) / (ms * 1e-3) / 1e12
            log(f"  K{3 if name == 'dq' else 4} ({name}): kernel {ms:.4f} ms "
                f"back to back, {tflops:.1f} TFLOP/s, bound {bound:.4f} ms "
                f"({bound_by}), {bound / ms:.1%} of the bound")
        log(f"  delta = rowsum(dO * O) in the wrapper {delta_ms:.4f} ms; "
            f"plain backward (dq, dk, dv) {plain_ms:.4f} ms; torch flash "
            f"backward (dq, dk, dv) {library_ms:.4f} ms back to back against "
            f"K3+K4 {dq_ms + dkv_ms:.4f} ms (with delta "
            f"{dq_ms + dkv_ms + delta_ms:.4f} ms)")
    return records


def phase_router():
    """The ledger's decisions at the main-path attention shapes, with their
    provenance. Returns {"prefill" | "train" | "bert": (Decision, whether
    the fused epilogue wins)}."""
    led = ar.load_ledger()
    if led is None:
        sys.exit("chip_smoke: the shipped attention ledger does not load")
    log(f"router: ledger v{led.get('version')} r{led.get('round')} of "
        f"{led.get('device_kind')} ({led.get('nvidia_smi')}), "
        f"{len(led.get('entries', []))} entries, "
        f"{len(led.get('end_to_end', []))} end-to-end")
    decisions = {}
    for name, case in (("prefill", PREFILL), ("train", TRAIN_ATTN),
                       ("bert", BERT_ATTN)):
        bh = case["b"] * case["h"]
        key = (bh, case["sq"], case["sk"], case["d"], torch.bfloat16,
               case["causal"])
        dec = ar.route(*key)
        wins = ar.epilogue_fusion_wins(*key)
        log(f"router {name} (bh {bh}, s{case['sq']}, d{case['d']}, bf16, "
            f"causal={case['causal']}): {dec}; fused epilogue wins: {wins}")
        if dec.source not in ("ledger", "ledger-e2e"):
            sys.exit(f"chip_smoke: the ledger has no row for the {name} "
                     f"shape on {torch.cuda.get_device_name(0)}")
        decisions[name] = (dec, wins)
    return decisions


def phase_tiny_reference():
    """A tiny llama in bf16 on the card against the same weights in f32 on
    the CPU (plain attention there)."""
    pt.seed(1)
    gpu = pt.models.llama_tiny(dtype="bfloat16", device="cuda")
    cpu = pt.models.llama_tiny(device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in gpu.state_dict().items()})
    ids = np.random.RandomState(1).randint(0, 512, (2, 64))
    with torch.inference_mode():
        got = gpu(torch.as_tensor(ids, device="cuda")).float().cpu()
        want = cpu(torch.as_tensor(ids))
    err = (got - want).abs().max().item()
    log(f"tiny llama bf16 on card vs f32 on CPU: max|logit err| {err:.3e} "
        f"(tol {TINY_LOGITS_ATOL}, max|logit| {want.abs().max().item():.3f})")
    if not err <= TINY_LOGITS_ATOL:
        sys.exit("chip_smoke: tiny llama on the card disagrees with the CPU")


def build_llama_7b():
    """llama_7b in bf16 at full width and depth, random weights from
    seed(0): the model of the serving phases."""
    pt.seed(0)
    t0 = time.perf_counter()
    model = pt.models.llama_7b(dtype="bfloat16", device="cuda")
    model.eval()
    torch.cuda.synchronize()
    cfg = model.config
    log(f"llama_7b: {model.num_params()} params, {cfg.num_hidden_layers} "
        f"layers, hidden {cfg.hidden_size}, built in "
        f"{time.perf_counter() - t0:.2f} s")
    return model


def phase_slice(decision, model):
    """llama_7b serving 4 x 512-token prompts; returns K1's launches over
    the main path. `decision` is the router's at the prefill shape: each
    generate launches K1 once per layer if its forward is the kernel, else
    never."""
    cfg = model.config
    b, s, new = 4, 512, 32
    ids = torch.as_tensor(
        np.random.RandomState(0).randint(0, cfg.vocab_size, (b, s)),
        device="cuda")
    sampled = dict(do_sample=True, temperature=0.8, top_p=0.9, seed=7)
    runs = [("greedy", new, {}), ("greedy", new, {}),
            ("sampled", new, sampled), ("sampled", new, sampled),
            ("prefill-only", 1, {})]
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_launches = 0                  # the main path starts here
    outs, secs = [], []
    for name, n, kw in runs:
        before = fa.flash_fwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = generation.generate(model, ids, max_new_tokens=n, **kw)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        launched = fa.flash_fwd_launches - before
        log(f"generate {name}: {tuple(out.shape)} in {secs[-1]:.3f} s, "
            f"K1 launches {launched}")
        want = cfg.num_hidden_layers if decision.fwd == "pallas" else 0
        if launched != want:
            sys.exit(f"chip_smoke: {launched} K1 launches in one generate, "
                     f"expected {want} (router: fwd={decision.fwd})")
        if out.shape != (b, s + n) or not torch.equal(out[:, :s], ids):
            sys.exit("chip_smoke: generate returned a wrong shape or prompt")
        if out.min().item() < 0 or out.max().item() >= cfg.vocab_size:
            sys.exit("chip_smoke: a token id is out of the vocabulary")
    peak = torch.cuda.max_memory_allocated()
    slice_int8(model, ids, new, decision, outs[0])
    launches = fa.flash_fwd_launches           # the main path ends here
    if not torch.equal(outs[0], outs[1]):
        sys.exit("chip_smoke: two greedy runs disagree")
    if not torch.equal(outs[2], outs[3]):
        sys.exit("chip_smoke: two sampled runs with one seed disagree")
    if not torch.equal(outs[4][:, s], outs[0][:, s]):
        sys.exit("chip_smoke: prefill-only first token differs from greedy")
    with torch.inference_mode():
        hidden = model.llama(ids)
    if not torch.isfinite(hidden).all():
        sys.exit("chip_smoke: non-finite prefill hidden state")
    prefill_ms = secs[4] * 1e3
    decode_ms = (secs[1] - secs[4]) / (new - 1) * 1e3
    log(f"slice: prefill {prefill_ms:.1f} ms (b{b} s{s}), decode "
        f"{decode_ms:.2f} ms/token step, greedy {b * new / secs[1]:.1f} "
        f"tokens/s ({b}x{new} in {secs[1]:.3f} s), sampled "
        f"{b * new / secs[3]:.1f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB, greedy tokens differ from sampled in "
        f"{(outs[0][:, s:] != outs[2][:, s:]).float().mean().item():.2%}")
    return launches


def slice_int8(model, ids, new, decision, bf16_greedy):
    """Phase 8's int8 step: WeightOnlyGenerator over the loaded llama_7b,
    greedy twice (the runs must agree, every id in the vocabulary) and a
    prefill-only call for timing, each launching K1 once per layer where
    the router picks it. Prints the times, the snapshot's bytes against
    the bf16 weights', peak memory, and the share of greedy tokens equal to
    the bf16 stream (for information only)."""
    cfg = model.config
    b, s = ids.shape
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    wog = generation.WeightOnlyGenerator(model, max_new_tokens=new)
    wog1 = generation.WeightOnlyGenerator(model, max_new_tokens=1,
                                          share_weights_from=wog)
    torch.cuda.synchronize()
    quantize_s = time.perf_counter() - t0
    want = cfg.num_hidden_layers if decision.fwd == "pallas" else 0
    outs, secs = [], []
    for name, gen in (("greedy", wog), ("greedy", wog),
                      ("prefill-only", wog1)):
        before = fa.flash_fwd_launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gen.generate(ids)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        outs.append(out)
        launched = fa.flash_fwd_launches - before
        log(f"int8 generate {name}: {tuple(out.shape)} in {secs[-1]:.3f} s, "
            f"K1 launches {launched}")
        if launched != want:
            sys.exit(f"chip_smoke: {launched} K1 launches in one int8 "
                     f"generate, expected {want} (router: fwd={decision.fwd})")
        if not torch.equal(out[:, :s], ids):
            sys.exit("chip_smoke: int8 generate returned a wrong prompt")
        if out.min().item() < 0 or out.max().item() >= cfg.vocab_size:
            sys.exit("chip_smoke: an int8 token id is out of the vocabulary")
    if not torch.equal(outs[0], outs[1]):
        sys.exit("chip_smoke: two int8 greedy runs disagree")
    if not torch.equal(outs[2][:, s], outs[0][:, s]):
        sys.exit("chip_smoke: int8 prefill-only first token differs")
    peak = torch.cuda.max_memory_allocated()
    qbytes = wog.quantized_bytes()
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    same = (outs[0][:, s:] == bf16_greedy[:, s:]).float().mean().item()
    prefill_ms = secs[2] * 1e3
    decode_ms = (secs[1] - secs[2]) / (new - 1) * 1e3
    log(f"slice int8 ({CARD}): snapshot in {quantize_s:.2f} s, prefill "
        f"{prefill_ms:.1f} ms (b{b} s{s}), decode {decode_ms:.2f} ms/token "
        f"step, greedy {b * new / secs[1]:.1f} tokens/s ({b}x{new} in "
        f"{secs[1]:.3f} s; the first greedy run {secs[0]:.3f} s), "
        f"quantized_bytes {qbytes} ({qbytes / 2**20:.1f} "
        f"MiB) against bf16 weights {wbytes} ({wbytes / 2**20:.1f} MiB), "
        f"peak memory {peak / 2**30:.2f} GiB (the bf16 model, the int8 "
        f"snapshot and one call's dequantized copy), greedy tokens equal to "
        f"the bf16 stream: {same:.2%} (information only)")
    del wog, wog1, outs
    gc.collect()
    torch.cuda.empty_cache()


def flash_launches():
    """K1 + K2 + K3 + K4 launches since their counters were last set."""
    return (fa.flash_fwd_launches + fa.flash_fwd_rms_epilogue_launches
            + fa.flash_bwd_dq_launches + fa.flash_bwd_dkv_launches)


def zero_flash_launches():
    fa.flash_fwd_launches = fa.flash_fwd_rms_epilogue_launches = 0
    fa.flash_bwd_dq_launches = fa.flash_bwd_dkv_launches = 0


def kernel_ms_traced(fn):
    """Summed kernel time (ms) of fn() under torch.profiler, None if the
    profiler saw no kernel. Kernels only: the host ops that launched them
    carry the same device time."""
    return sum(kernel_ms_by_class(fn).values()) or None


def resnet_class(name):
    low = name.lower()
    return next((cls for cls, keys in RESNET_CLASSES
                 if any(k in low for k in keys)),
                None) or profile_train._classify(name)


def kernel_ms_by_class(fn, classify=profile_train._classify, kernels=None,
                       census=None):
    """{kernel class: summed device ms} of fn() under torch.profiler, by
    default the classes of tools/profile_train.py (the flash kernels,
    matrix products, copies, elementwise, reductions, other). With a list
    as `kernels`, (device ms, launches, name) of every kernel is appended
    to it. With a dict as `census`, it gets the trace's kernel records
    ("kernels") and its host-side kernel launch calls ("launches"); a
    trace with fewer records than launches lost kernels, and says so."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    census = {"kernels": 0, "launches": 0} if census is None else census
    census.update(kernels=0, launches=0)
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            cls = classify(e.key)
            ms = getattr(e, "device_time_total",
                         getattr(e, "cuda_time_total", 0)) / 1e3
            out[cls] = out.get(cls, 0.0) + ms
            if kernels is not None:
                kernels.append((ms, e.count, e.key))
            if not e.key.startswith(("Memcpy", "Memset")):
                census["kernels"] += e.count
        elif "LaunchKernel" in e.key:
            census["launches"] += e.count
    if census["kernels"] < census["launches"]:
        log(f"trace: {census['kernels']} kernel records of "
            f"{census['launches']} launch calls: it lost kernels")
    return out


def class_line(by_class):
    """The total of kernel_ms_by_class's result, then each class's ms and
    share, largest first."""
    total = sum(by_class.values())
    return f"{total:.3f} ms of kernels: " + "; ".join(
        f"{cls} {ms:.3f} ms ({ms / total:.1%})"
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]))


def engine_traffic(vocab):
    """The engine phase's 16 prompts (lengths 64-1536 and ids from
    RandomState(0)) and each request's knobs."""
    rs = np.random.RandomState(0)
    lengths = rs.randint(64, 1537, ENGINE_REQUESTS)
    prompts = [rs.randint(0, vocab, n) for n in lengths]
    knobs = [dict(ENGINE_SAMPLED, seed=100 + i) if i in ENGINE_SAMPLED_AT
             else {} for i in range(ENGINE_REQUESTS)]
    return prompts, knobs


def serve_traffic(model, prompts, knobs, decode_steps, on_step=None):
    """One engine run of the phase's traffic: half the requests before the
    first step, the rest after the third. Returns the engine, the streams,
    the K1-K4 launches from the first add_request to the last token, the
    host-clock wall of the run and of its decode window (the steps after
    the last prefill chunk), and the window's first step."""
    eng = ContinuousBatchingEngine(model, decode_steps=decode_steps,
                                   **ENGINE)
    half = ENGINE_REQUESTS // 2
    torch.cuda.synchronize()
    zero_flash_launches()                    # the path starts here
    t0 = time.perf_counter()
    rids = [eng.add_request(p, max_new_tokens=ENGINE_NEW, **kw)
            for p, kw in zip(prompts[:half], knobs[:half])]
    steps, window = 0, None
    while eng.has_work():
        eng.step()
        steps += 1
        if steps == 3:
            rids += [eng.add_request(p, max_new_tokens=ENGINE_NEW, **kw)
                     for p, kw in zip(prompts[half:], knobs[half:])]
        if (window is None and steps > 3 and not eng.queue
                and not eng._prefill_tasks):
            torch.cuda.synchronize()
            window = (steps + 1, time.perf_counter())
        if on_step is not None:
            on_step(eng, steps)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    launches = flash_launches()              # and ends at the last token
    streams = [eng.finished[r].generated for r in rids]
    reasons = [eng.finished[r].finish_reason for r in rids]
    return dict(engine=eng, streams=streams, reasons=reasons, steps=steps,
                launches=launches, wall=t1 - t0, window_step=window[0],
                window_wall=t1 - window[1])


def graph_matches_eager(eng):
    """Each decode program, greedy and sampled at K 1 and 4, replayed from
    its graph and run eagerly on the same lane state must give the same
    tile. The lane state is restored after each run, so the engine goes on
    as if neither had happened."""
    with torch.no_grad():
        eng._drain_all()
        if eng._dirty:
            eng._upload_lane_state(eng._decode_active())
        snap = {k: v.clone() for k, v in eng._dev.items()}

        def restore():
            for k, v in snap.items():
                eng._dev[k].copy_(v)
        same = []
        for sampled in (False, True):
            for k in (1, 4):
                prog = eng._graphs.get((sampled, k, 0))
                if prog is None:
                    prog = eng._graphs[(sampled, k, 0)] = eng._capture(
                        sampled, k)
                    eng.graph_captures += 1
                restore()
                prog.graph.replay()
                replayed = prog.tile.clone()
                restore()
                eager = eng._decode_tile(sampled, k)
                restore()
                same.append(((sampled, k), torch.equal(replayed, eager),
                             int(eng._dev["alive"].sum())))
    return same


def engine_device_ms(eng, layer=None):
    """CUDA-event medians, on the engine of a finished run, of one prefill
    chunk of 512 tokens (its layers as written, or `layer`'s compiled
    program) and of one decode tile, greedy and sampled, over all 8 lanes
    at position 1,024 (profile_serving.lane_state), the lane state
    restored before each replay."""
    d = eng._dev
    reset_greedy = profile_serving.lane_state(eng, eng.embed_w.shape[0])

    def reset_sampled():
        reset_greedy()
        d["do_sample"].fill_(True)
        d["seeds"].copy_(torch.arange(eng.max_batch, device=eng.device))
        d["temp"].fill_(ENGINE_SAMPLED["temperature"])
        d["top_k"].fill_(ENGINE_SAMPLED["top_k"])
        d["top_p"].fill_(ENGINE_SAMPLED["top_p"])
    ids = torch.as_tensor(np.random.RandomState(3).randint(
        0, eng.embed_w.shape[0], (1, 512)), device=eng.device)
    with torch.no_grad():
        reset_greedy()
        table = d["tables"][0].clone()
        chunk_ms = profile_serving.median_ms(
            lambda: eng._prefill_chunk(ids, 0, 511, table, layer=layer),
            reset_greedy)
        tile_ms = {}
        for sampled, reset in ((False, reset_greedy), (True, reset_sampled)):
            key = (sampled, eng.decode_steps, 0)
            if key not in eng._graphs:
                eng._graphs[key] = eng._capture(*key)
                eng.graph_captures += 1
            tile_ms["sampled" if sampled else "greedy"] = \
                profile_serving.median_ms(eng._graphs[key].graph.replay,
                                          reset)
    for lane in range(eng.max_batch):
        eng.pool.release(lane)
    return chunk_ms, tile_ms


def chunk_logits_check(eng, model, prompts):
    """Each prompt's first chunk through the engine's prefill program (into
    blocks reserved for the check) against the dense model forward: the
    logits of the chunk's last position. Returns the largest error over
    the largest |logit| and the engine's logits of each prompt."""
    worst, logits = 0.0, []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            n = min(len(p), eng.chunk)
            table = torch.full((ENGINE["max_blocks_per_seq"],),
                               eng.pool.scratch_block, dtype=torch.int64)
            t = eng.pool.ensure(("check", i), n)
            table[:len(t)] = torch.as_tensor(t)
            ids = torch.as_tensor(p[:n], device=eng.device)[None]
            got = eng._prefill_chunk(ids, 0, n - 1, table.to(eng.device))
            want = model(ids)[0, n - 1].float()
            eng.pool.release(("check", i))
            if not (torch.isfinite(got).all() and torch.isfinite(want).all()):
                sys.exit("chip_smoke: non-finite first-chunk logits")
            worst = max(worst, (got - want).abs().max().item()
                        / want.abs().max().item())
            logits.append(got)
    return worst, logits


def hist_median(name):
    fam = obs.get_registry().get(name)
    if fam is None or not fam.count:
        return None
    return quantile_from_cumulative(fam.cumulative_buckets(), 0.5)


def phase_engine(model):
    """llama_7b served through ContinuousBatchingEngine: chunked prefill
    into the paged bf16 pool, and the fused K-step decode replayed from
    one CUDA graph per (variant, K). Three runs of the traffic: two at
    decode_steps 4 (timed; the second traced over its decode window) and
    one at decode_steps 1, which also holds every decode graph against
    the same program run eagerly. Then generate at the same batch, for
    comparison. Returns run 1's streams and each prompt's first-chunk
    logits, which the knob phase holds its engines against."""
    cfg = model.config
    prompts, knobs = engine_traffic(cfg.vocab_size)
    log(f"engine: {ENGINE_REQUESTS} requests, prompts {min(map(len, prompts))}"
        f"-{max(map(len, prompts))} tokens ({sum(map(len, prompts))} in "
        f"all), {ENGINE_NEW} new tokens each, sampled at "
        f"{list(ENGINE_SAMPLED_AT)} ({ENGINE_SAMPLED}), knobs {ENGINE}")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.get_registry().reset()
    obs.enable()
    a = serve_traffic(model, prompts, knobs, 4)
    peak = torch.cuda.max_memory_allocated()
    reg = obs.get_registry()
    uploads = reg.get("serving_lane_state_uploads_total").value
    dispatches = reg.get("serving_decode_dispatches_total").value
    ttft, tpot = (hist_median("serving_ttft_seconds"),
                  hist_median("serving_tpot_seconds"))
    obs.disable()
    eng = a["engine"]
    captures = eng.graph_captures
    chunk_ms, tile_ms = engine_device_ms(eng)
    PHASE9.update(chunk_ms=chunk_ms, tile_ms=tile_ms, launches=None)
    worst, chunk_logits = chunk_logits_check(eng, model, prompts)
    del eng, a["engine"]
    gc.collect()
    torch.cuda.empty_cache()

    def traced_window(e, step):
        if step + 1 == b_window[0]:
            b_window[1] = kernel_ms_traced(
                lambda: [e.step() for _ in range(b_window[2])])
    b_window = [a["window_step"], None, a["steps"] - a["window_step"] + 1]
    b = serve_traffic(model, prompts, knobs, 4, on_step=traced_window)
    del b["engine"]
    gc.collect()
    torch.cuda.empty_cache()
    checks = []
    c = serve_traffic(model, prompts, knobs, 1, on_step=lambda e, step: (
        checks.extend(graph_matches_eager(e)) if step == 6 else None))
    del c["engine"]
    gc.collect()
    torch.cuda.empty_cache()

    tokens = sum(map(len, a["streams"]))
    K, B = 4, ENGINE["max_batch"]
    busy = (None if b_window[1] is None
            else b_window[1] / 1e3 / a["window_wall"])
    log(f"engine: prefill chunk of 512 tokens {chunk_ms:.3f} ms (CUDA "
        f"events, median of 5)")
    log(f"engine: decode tile K={K} over {B} lanes {tile_ms['greedy']:.3f} "
        f"ms greedy, {tile_ms['sampled']:.3f} ms sampled (graph replay, "
        f"CUDA events, median of 5): {tile_ms['greedy'] / K:.3f} ms per "
        f"token per lane, {tile_ms['greedy'] / (K * B):.4f} ms per token")
    log(f"engine: {tokens} tokens in {a['wall']:.3f} s, "
        f"{tokens / a['wall']:.1f} tokens/s ({a['steps']} steps, host "
        f"clock, prefill included); TTFT median "
        f"{ttft if ttft is None else f'{ttft:.4f}'} s, TPOT median "
        f"{tpot if tpot is None else f'{tpot:.5f}'} s (catalog "
        f"histograms, bucket-interpolated)")
    log(f"engine: decode window steps {a['window_step']}-{a['steps']} "
        f"{a['window_wall'] * 1e3:.1f} ms host clock, kernels "
        + ("not measured (the profiler saw no kernel)" if busy is None else
           f"{b_window[1]:.1f} ms (traced twin run), device busy {busy:.1%}"))
    log(f"engine: peak memory {peak / 2**30:.2f} GiB, graph captures "
        f"{captures}, lane-state uploads {uploads:.0f} (membership changes at "
        f"most {2 * ENGINE_REQUESTS}), decode dispatches {dispatches:.0f} "
        f"(run 1); K1-K4 launches {a['launches']}, {b['launches']}, "
        f"{c['launches']} (runs 1, 2 and decode_steps 1)")
    log(f"engine: first-chunk logits vs the dense forward: max|err| / "
        f"max|logit| {worst:.3e} (tol {ENGINE_LOGITS_RTOL})")
    log("engine: graph replay vs eager tile " + ", ".join(
        f"{'sampled' if s else 'greedy'} K{k} {'same' if ok else 'DIFFERENT'}"
        f" ({n} lanes alive)" for (s, k), ok, n in checks))
    for name, run in (("run 1", a), ("run 2", b), ("decode_steps 1", c)):
        if any(len(s) != ENGINE_NEW for s in run["streams"]) or any(
                r != "length" for r in run["reasons"]):
            sys.exit(f"chip_smoke: engine {name}: a request did not finish "
                     f"with {ENGINE_NEW} tokens")
        if any(t < 0 or t >= cfg.vocab_size for s in run["streams"]
               for t in s):
            sys.exit(f"chip_smoke: engine {name}: a token id is out of the "
                     f"vocabulary")
        if run["launches"] != 0:
            sys.exit(f"chip_smoke: engine {name} launched K1-K4 "
                     f"{run['launches']} times")
    PHASE9["launches"] = a["launches"]
    if a["streams"] != b["streams"]:
        sys.exit("chip_smoke: two engine runs with the same seeds differ")
    if a["streams"] != c["streams"]:
        sys.exit("chip_smoke: engine streams differ between decode_steps 4 "
                 "and 1")
    if not checks or not all(ok for _, ok, _ in checks):
        sys.exit("chip_smoke: a decode tile replayed from its graph differs "
                 "from the same tile run eagerly")
    if uploads > 2 * ENGINE_REQUESTS:
        sys.exit("chip_smoke: more lane-state uploads than membership "
                 "changes")
    if not worst <= ENGINE_LOGITS_RTOL:
        sys.exit("chip_smoke: engine first-chunk logits disagree with the "
                 "dense forward")
    phase_engine_generate(model, tokens_per_lane=ENGINE_NEW)
    return a["streams"], chunk_logits


def phase_engine_generate(model, tokens_per_lane):
    """generate at the engine phase's batch (8 prompts of 512 tokens,
    `tokens_per_lane` new tokens), for comparison: its prefill is its
    TTFT and its decode step its TPOT."""
    gc.collect()
    torch.cuda.empty_cache()
    b, s = ENGINE["max_batch"], 512
    ids = torch.as_tensor(np.random.RandomState(1).randint(
        0, model.config.vocab_size, (b, s)), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    secs = []
    for n in (1, tokens_per_lane):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generation.generate(model, ids, max_new_tokens=n)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    peak = torch.cuda.max_memory_allocated()
    decode_s = (secs[1] - secs[0]) / (tokens_per_lane - 1)
    short = 8
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    generation.generate(model, ids, max_new_tokens=short)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    traced = kernel_ms_traced(
        lambda: generation.generate(model, ids, max_new_tokens=short))
    log(f"generate b{b} s{s}, {tokens_per_lane} new tokens: prefill (TTFT) "
        f"{secs[0] * 1e3:.1f} ms, decode step (TPOT) {decode_s * 1e3:.2f} "
        f"ms, {b * tokens_per_lane / secs[1]:.1f} tokens/s ({secs[1]:.3f} s, "
        f"host clock), peak memory {peak / 2**30:.2f} GiB, graph captures 0; "
        f"{short}-token call {wall * 1e3:.1f} ms, kernels "
        + ("not measured" if traced is None else
           f"{traced:.1f} ms, device busy {traced / 1e3 / wall:.1%}"))


def knob_traffic(vocab):
    """The knob phase's mixes: phase 9's 16 requests, the motif mix and
    the shared-prefix mix, as [(prompt, request knobs)]."""
    prompts, knobs = engine_traffic(vocab)
    mix9 = [(p, dict(kw, max_new_tokens=ENGINE_NEW))
            for p, kw in zip(prompts, knobs)]
    motif = np.random.RandomState(7).randint(0, vocab, (5,))
    mix_motif = [(np.tile(motif, MOTIF_PROMPT // 5 + 1)[:MOTIF_PROMPT],
                  dict(max_new_tokens=MOTIF_NEW))] * MOTIF_REQUESTS
    rs = np.random.RandomState(11)
    prefix = rs.randint(0, vocab, PREFIX_LEN)
    mix_prefix = [(np.concatenate([prefix, rs.randint(0, vocab, t)]),
                   dict(max_new_tokens=ENGINE_NEW)) for t in PREFIX_TAILS]
    return mix9, mix_motif, mix_prefix


def knob_run(model, reqs, plan="waves", on_step=None, engine=None, **kw):
    """One engine run of `reqs` through ContinuousBatchingEngine at phase
    9's knobs plus `kw` (or on `engine`). plan "waves": half the requests
    before the first step, the rest after the third (phase 9's); "all":
    every request at once; "first": one request, the rest once its prefill
    is done. Observability on, from zero. Returns the engine, the streams,
    finish reasons, K1-K4 launches from the first add_request to the last
    token, and the run's numbers."""
    eng = engine if engine is not None else ContinuousBatchingEngine(
        model, **{**ENGINE, "decode_steps": 4, **kw})
    obs.get_registry().reset()
    obs.enable()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = {"waves": len(reqs) // 2, "all": len(reqs), "first": 1}[plan]
    zero_flash_launches()                    # the path starts here
    t0 = time.perf_counter()
    rids = [eng.add_request(p, **rk) for p, rk in reqs[:first]]
    steps = 0
    while eng.has_work() or len(rids) < len(reqs):
        eng.step()
        steps += 1
        late = ((plan == "waves" and steps == 3)
                or (plan == "first" and not eng.queue
                    and not eng._prefill_tasks))
        if late and len(rids) < len(reqs):
            rids += [eng.add_request(p, **rk) for p, rk in reqs[first:]]
        if on_step is not None:
            on_step(eng, steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = flash_launches()              # and ends at the last token
    reg = obs.get_registry()

    def value(name):
        fam = reg.get(name)
        return 0.0 if fam is None else fam.value
    streams = [eng.finished[r].generated for r in rids]
    tokens = sum(map(len, streams))
    dispatches = value("serving_decode_dispatches_total")
    drafted = value("serving_draft_tokens_total")
    run = dict(
        engine=eng, streams=streams, launches=launches, wall=wall,
        reasons=[eng.finished[r].finish_reason for r in rids],
        tokens=tokens, steps=steps,
        # decode tokens (every token but each request's first, which its
        # prefill chooses) over decode dispatches
        per_dispatch=(tokens - len(rids)) / max(1.0, dispatches),
        acceptance=(value("serving_accepted_tokens_total") / drafted
                    if drafted else None),
        ttft=hist_median("serving_ttft_seconds"),
        tpot=hist_median("serving_tpot_seconds"),
        peak=torch.cuda.max_memory_allocated(),
        captures=eng.graph_captures, keys=sorted(eng.program_keys_used),
        prefix=dict(saved=value("serving_prefix_tokens_saved_total"),
                    shared=value("serving_prefix_shared_blocks"),
                    forks=value("serving_prefix_cow_forks_total"),
                    hits=value("serving_prefix_hits_total")))
    obs.disable()
    return run


def knob_report(name, run):
    """One line of a knob run's numbers, beside the card."""
    fmt = (lambda x, f: "not measured" if x is None else f.format(x))
    log(f"knobs {name} [{CARD}]: {run['tokens']} tokens in "
        f"{run['wall']:.3f} s, {run['tokens'] / run['wall']:.1f} tokens/s "
        f"(host clock, prefill included), {run["per_dispatch"]:.3f} tokens "
        f"per dispatch (all lanes), acceptance {fmt(run['acceptance'], '{:.4f}')}, "
        f"TTFT median {fmt(run['ttft'], '{:.4f}')} s, TPOT median "
        f"{fmt(run['tpot'], '{:.5f}')} s, peak memory "
        f"{run['peak'] / 2**30:.2f} GiB, graph captures {run['captures']} "
        f"for keys {run['keys']} (sampled, K, draft depth)")


def knob_check(name, run, want=None, new=None):
    """Fail the phase if a run launched K1-K4, a stream did not finish
    with its tokens in the vocabulary, or the streams differ from
    `want`."""
    if run["launches"] != 0:
        sys.exit(f"chip_smoke: knobs {name} launched K1-K4 "
                 f"{run['launches']} times")
    vocab = run["engine"].embed_w.shape[0]
    for s, reason, n in zip(run["streams"], run["reasons"],
                            new or [None] * len(run["streams"])):
        if reason != "length" or (n is not None and len(s) != n):
            sys.exit(f"chip_smoke: knobs {name}: a request ended "
                     f"{reason} with {len(s)} tokens")
        if any(t < 0 or t >= vocab for t in s):
            sys.exit(f"chip_smoke: knobs {name}: a token id is out of the "
                     "vocabulary")
    if want is not None and run["streams"] != want:
        bad = sum(a != b for a, b in zip(run["streams"], want))
        sys.exit(f"chip_smoke: knobs {name}: {bad} streams differ from the "
                 "run they must equal")


def graph_tile_ms(eng):
    """CUDA-event medians (5 replays) of every decode graph the engine
    captured, all 8 lanes alive at position 1,024 (profile_serving's lane
    state; sampled graphs with phase 9's sampling knobs, speculative ones
    over a history of motif tokens, adapter lanes on slots 0-7), the lane
    state restored before each replay."""
    d, B = eng._dev, eng.max_batch
    vocab = eng.embed_w.shape[0]
    reset_lanes = profile_serving.lane_state(eng, vocab)
    hist = None
    if "hist" in d:
        motif = np.random.RandomState(7).randint(0, vocab, (5,))
        hist = torch.as_tensor(np.tile(motif, d["hist"].shape[1] // 5 + 1)[
            :d["hist"].shape[1]], device=eng.device).expand(B, -1)
    out = {}
    with torch.no_grad():
        for key, prog in sorted(eng._graphs.items()):
            sampled, K, D = key

            def reset():
                reset_lanes()
                d["do_sample"].fill_(sampled)
                d["seeds"].copy_(torch.arange(B, device=eng.device))
                d["temp"].fill_(ENGINE_SAMPLED["temperature"])
                d["top_k"].fill_(ENGINE_SAMPLED["top_k"])
                d["top_p"].fill_(ENGINE_SAMPLED["top_p"])
                if hist is not None:
                    d["hist"].copy_(hist)
                if "adapter_ids" in d:
                    d["adapter_ids"].copy_(
                        torch.arange(B, device=eng.device)
                        % eng.adapters.n_slots)
            name = (("sampled" if sampled else "greedy") + f" K={K}"
                    + (f" spec D={D}" if D else ""))
            out[name] = profile_serving.median_ms(prog.graph.replay, reset)
    for lane in range(B):
        eng.pool.release(lane)
    log(f"knobs tiles, {eng.pool.fmt.name} pool"
        + (", adapter store" if eng.adapters is not None else "")
        + f" [{CARD}]: " + ", ".join(
        f"{k} {v:.3f} ms" for k, v in out.items())
        + " (graph replay over 8 lanes at position 1,024, CUDA events, "
        "median of 5)")
    return out


def free(*runs):
    """Drop the runs' engines and their pools."""
    for run in runs:
        run.pop("engine", None)
    gc.collect()
    torch.cuda.empty_cache()


def knobs_spec(model, mix9, mix_motif, plain9):
    """Speculative decode on phase 9's mix (against phase 9's plain
    streams, at decode_steps 4 and 1) and on the motif mix (against its
    own plain run)."""
    new9 = [ENGINE_NEW] * len(mix9)
    s4 = knob_run(model, mix9, **KNOB_SPEC)
    knob_report("spec mix16 K=4", s4)
    knob_check("spec mix16 K=4", s4, plain9, new9)
    graph_tile_ms(s4["engine"])
    free(s4)
    s1 = knob_run(model, mix9, **dict(KNOB_SPEC, decode_steps=1))
    knob_report("spec mix16 K=1", s1)
    knob_check("spec mix16 K=1", s1, plain9, new9)
    free(s1)
    newm = [MOTIF_NEW] * len(mix_motif)
    pm = knob_run(model, mix_motif, plan="all")
    knob_report("plain motif", pm)
    knob_check("plain motif", pm, new=newm)
    sm = knob_run(model, mix_motif, plan="all", **KNOB_SPEC)
    knob_report("spec motif", sm)
    knob_check("spec motif", sm, pm["streams"], newm)
    graph_tile_ms(sm["engine"])
    free(pm, sm)
    return s4, sm


def first_chunk_logits(eng, prompts):
    """Each prompt's first chunk through the engine's prefill program,
    into blocks reserved for the check: the chunk's last-position
    logits."""
    out = []
    with torch.no_grad():
        for i, p in enumerate(prompts):
            n = min(len(p), eng.chunk)
            table = torch.full((ENGINE["max_blocks_per_seq"],),
                               eng.pool.scratch_block, dtype=torch.int64)
            t = eng.pool.ensure(("check", i), n)
            table[:len(t)] = torch.as_tensor(t)
            ids = torch.as_tensor(p[:n], device=eng.device)[None]
            out.append(eng._prefill_chunk(ids, 0, n - 1,
                                          table.to(eng.device)))
            eng.pool.release(("check", i))
    return out


def knobs_quant(model, mix9, bf16_logits):
    """int8 and fp8_e4m3 pools at the bf16 pool's bytes: capacity, first-
    chunk logits against the bf16 pool's, spec streams against plain ones
    within each format, and one int8 run that forces the kv-dequant
    degradation, which must capture again and finish every stream."""
    cfg = model.config
    hd = cfg.hidden_size // cfg.num_attention_heads
    bf16_bytes = (ENGINE["num_blocks"] * cfg.num_hidden_layers
                  * ENGINE["block_size"] * 2 * cfg.num_key_value_heads * hd
                  * 2)
    new9 = [ENGINE_NEW] * len(mix9)
    out = {}
    for fmt in ("int8", "fp8_e4m3"):
        kw = dict(kv_cache_dtype=fmt, kv_pool_bytes=bf16_bytes)
        q = knob_run(model, mix9, **kw)
        eng = q["engine"]
        ratio = eng.pool.num_blocks / ENGINE["num_blocks"]
        got = first_chunk_logits(eng, [p for p, _ in mix9])
        err = max(((g - w).abs().max() / w.abs().max()).item()
                  for g, w in zip(got, bf16_logits))
        knob_report(f"{fmt} plain", q)
        log(f"knobs {fmt} [{CARD}]: pool of {bf16_bytes} bytes holds "
            f"{eng.pool.num_blocks} blocks, {ratio:.3f}x the bf16 pool's "
            f"{ENGINE['num_blocks']}; first-chunk logits vs the bf16 pool: "
            f"max|err| / max|logit| {err:.3e} (tol "
            f"{QUANT_LOGITS_RTOL[fmt]})")
        knob_check(f"{fmt} plain", q, new=new9)
        graph_tile_ms(eng)
        if ratio < QUANT_MIN_BLOCKS:
            sys.exit(f"chip_smoke: the {fmt} pool holds {ratio:.3f}x the "
                     f"bf16 pool's blocks, below {QUANT_MIN_BLOCKS}")
        if not err <= QUANT_LOGITS_RTOL[fmt]:
            sys.exit(f"chip_smoke: {fmt} first-chunk logits disagree with "
                     "the bf16 pool's")
        free(q)
        qs = knob_run(model, mix9, **kw, **KNOB_SPEC)
        knob_report(f"{fmt} spec", qs)
        knob_check(f"{fmt} spec", qs, q["streams"], new9)
        graph_tile_ms(qs["engine"])
        free(qs)
        out[fmt] = (q, qs)
    pt.set_flags({"FLAGS_fault_injection": KV_DEQUANT_FAULT})
    try:
        f = knob_run(model, mix9, kv_cache_dtype="int8",
                     kv_pool_bytes=bf16_bytes, **KNOB_SPEC)
    finally:
        pt.set_flags({"FLAGS_fault_injection": ""})
    eng = f["engine"]
    knob_report("int8 spec, kv-dequant forced", f)
    knob_check("int8 spec, kv-dequant forced", f, new=new9)
    if eng.pool.fmt.quantized or f["captures"] <= len(f["keys"]):
        sys.exit("chip_smoke: the forced kv-dequant degradation did not "
                 "leave a native pool captured again")
    log(f"knobs kv-dequant [{CARD}]: pool now {eng.pool.k.dtype}, "
        f"{f['captures']} captures for {len(f['keys'])} keys")
    free(f)
    return out


def knobs_adapters(model, mix9):
    """An AdapterStore from demo_store_for_engine: 4 base lanes equal the
    storeless engine's streams, each adapter lane repeats across two runs,
    and a fifth adapter registered mid-run (a hot swap) adds no graph
    capture."""
    reqs = [(p, dict(kw, max_new_tokens=ENGINE_NEW))
            for p, kw in mix9[:8]]
    names = ADAPTERS["names"]
    plain = knob_run(model, reqs, plan="all")
    knob_report("adapters storeless", plain)
    knob_check("adapters storeless", plain, new=[ENGINE_NEW] * 8)
    store = demo_store_for_engine(plain["engine"], names,
                                  rank=ADAPTERS["rank"],
                                  n_slots=ADAPTERS["n_slots"],
                                  scale=ADAPTERS["scale"])
    free(plain)
    with_ad = [(p, dict(kw, adapter=names[i - 4] if i >= 4 else None))
               for i, (p, kw) in enumerate(reqs)]
    first = knob_run(model, with_ad, plan="all", adapters=store)
    engine = first.pop("engine")
    swap = {}

    def hot_swap(eng, step):
        if step == 3:
            swap["before"] = (eng.graph_captures,
                              set(eng.program_keys_used))
            r = np.random.RandomState(6)
            L, H, R = store.num_layers, store.hidden, store.rank
            store.register("ad4", *(
                r.randn(*shape).astype(np.float32) * ADAPTERS["scale"]
                for shape in ((L, H, R), (L, R, store.q_out), (L, H, R),
                              (L, R, store.v_out))))
            swap["rid"] = eng.add_request(reqs[0][0], max_new_tokens=16,
                                          adapter="ad4")
    hot = knob_run(model, with_ad, plan="all", engine=engine,
                   on_step=hot_swap)
    first["engine"] = engine
    swapped = engine.finished[swap["rid"]]
    slot = store.resident().get("ad4")
    knob_report("adapters store run 1", first)
    knob_report("adapters store run 2, hot swap", hot)
    for name, run in (("adapters store run 1", first),
                      ("adapters hot swap", hot)):
        knob_check(name, run, new=[ENGINE_NEW] * 8)
        if run["streams"][:4] != plain["streams"][:4]:
            sys.exit(f"chip_smoke: {name}: a base lane differs from the "
                     "storeless engine's")
    if first["streams"][4:] != hot["streams"][4:]:
        sys.exit("chip_smoke: an adapter lane differs between two runs")
    if first["streams"][4:] == plain["streams"][4:]:
        sys.exit("chip_smoke: the adapter lanes equal the base model's")
    # captures after the swap: only those of program keys first used
    # after it (a lane mix that turns all-greedy, say), never a recapture
    new_keys = set(hot["keys"]) - swap["before"][1]
    if (swapped.finish_reason != "length"
            or hot["captures"] - swap["before"][0] != len(new_keys)):
        sys.exit("chip_smoke: the hot swap did not serve, or added a "
                 "graph capture")
    log(f"knobs adapters [{CARD}]: base lanes equal the storeless "
        f"engine's; adapter lanes repeat; hot swap of ad4 into slot "
        f"{slot} added no capture ({hot['captures']} captures, "
        f"{len(new_keys)} for program keys first used after it); store "
        f"{store.stats()}")
    graph_tile_ms(engine)
    del engine
    free(first, hot)


def knobs_prefix(model, mix_prefix):
    """The shared-prefix mix with the prefix cache on and off: equal
    streams; prefill tokens saved, shared blocks, COW forks, TTFT."""
    new = [ENGINE_NEW] * len(mix_prefix)
    runs = {}
    for on in (False, True):
        run = knob_run(model, mix_prefix, plan="first", prefix_cache=on,
                       prefill_buckets=PREFIX_BUCKETS)
        name = f"prefix cache {'on' if on else 'off'}"
        knob_report(name, run)
        knob_check(name, run, runs.get(False, {}).get("streams"), new)
        log(f"knobs {name} [{CARD}]: prefill tokens saved "
            f"{run['prefix']['saved']:.0f}, hits {run['prefix']['hits']:.0f}"
            f", shared blocks {run['prefix']['shared']:.0f}, COW forks "
            f"{run['prefix']['forks']:.0f}, TTFT median "
            f"{run['ttft']:.4f} s")
        free(run)
        runs[on] = run
    if runs[True]["prefix"]["forks"] < 1 or runs[True]["prefix"]["saved"] < (
            len(mix_prefix) - 1) * (PREFIX_LEN - 1):
        sys.exit("chip_smoke: the prefix cache shared less than the prefix")
    return runs


def knobs_scheduler(model, mix9):
    """SLOScheduler on phase 9's mix with 4 best_effort requests, and
    speculation: a run without preemption, then one that forces a
    preemption and steps the ladder to disable_speculation (K 4 -> 2,
    depth 2 -> 1, no speculation) and lets it recover. Streams must be
    equal; captures must equal the distinct program keys."""
    reqs = [(p, dict(kw, priority="best_effort" if i % 4 == 3
                     else "interactive"))
            for i, (p, kw) in enumerate(mix9)]
    # wall-clock targets off and no escalation of the ladder's own: it
    # moves only where the script moves it (a TTFT breach, or the cost
    # model's headroom while a wave arrives, could engage
    # cap_max_new_tokens mid-run)
    sched = dict(ttft_target=1e9, tpot_target=1e9, escalate_after=10**9)
    base = knob_run(model, reqs, scheduler=SLOScheduler(**sched),
                    **KNOB_SPEC)
    knob_report("scheduler", base)
    knob_check("scheduler", base, new=[ENGINE_NEW] * len(reqs))
    free(base)
    forced = {}

    def drive(eng, step):
        # once the second wave is in: preempt a decoding lane, and on the
        # next step move the ladder
        if "preempt" in forced and "ladder" not in forced:
            # a transition starts the ladder's dwell and recovery streak,
            # so the rung holds for a few dispatches before it recovers
            eng.scheduler._transition(level_index("disable_speculation"),
                                      "up")
            eng.scheduler._apply(eng)
            forced["ladder"] = (eng.decode_steps, eng.draft_depth, eng.spec)
        elif step >= 4 and eng._decode_active() and "preempt" not in forced:
            forced["preempt"] = eng._try_preempt(eng._decode_active()[0],
                                                 why="drill")
    run = knob_run(model, reqs, on_step=drive,
                   scheduler=SLOScheduler(**sched), **KNOB_SPEC)
    eng = run["engine"]
    knob_report("scheduler, preempted and laddered", run)
    knob_check("scheduler, preempted and laddered", run, base["streams"],
               [ENGINE_NEW] * len(reqs))
    log(f"knobs scheduler [{CARD}]: preempted {forced.get('preempt')}, "
        f"ladder at disable_speculation gave (K, depth, spec) "
        f"{forced.get('ladder')}, back to level {eng.scheduler.level}; "
        f"transitions down {eng.scheduler.transitions_down}")
    if (not forced.get("preempt") or forced.get("ladder") != (2, 1, False)
            or not any(k[1:] == (2, 0) for k in run["keys"])
            or run["captures"] != len(run["keys"])):
        sys.exit("chip_smoke: the scheduler drill did not preempt, step "
                 "the ladder, or captured other than once per key")
    free(run)


def phase_knobs(model, plain9, bf16_logits):
    """The engine's knobs on llama_7b at phase 9's knobs: speculative
    decode, quantized KV, adapters, the prefix cache and the SLO
    scheduler. Every decode program is a captured CUDA graph; K1-K4 must
    not launch."""
    mix9, mix_motif, mix_prefix = knob_traffic(model.config.vocab_size)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    knobs_spec(model, mix9, mix_motif, plain9)
    knobs_quant(model, mix9, bf16_logits)
    knobs_adapters(model, mix9)
    knobs_prefix(model, mix_prefix)
    knobs_scheduler(model, mix9)
    log(f"knobs: phase done in {time.perf_counter() - t0:.1f} s")


def loadgen_engine(model, warm=True, **kw):
    """A fresh engine at phase 9's knobs with a bounded admission queue.
    With `warm`, two short requests run first, so the first dispatch of
    the run is not the decode graph's capture."""
    eng = ContinuousBatchingEngine(model, decode_steps=4,
                                   max_queue=LOADGEN_QUEUE, **ENGINE, **kw)
    if warm:
        eng.add_request(np.arange(1, 8), max_new_tokens=12)
        eng.add_request(np.arange(1, 21), max_new_tokens=12)
        eng.run()
        eng.finished.clear()
    return eng


def loadgen_run(eng, scenario, **kw):
    """run_scenario with observability and the phase accountant on, from
    zero; returns the report and the K1-K4 launches of the run."""
    obs.get_registry().reset()
    obs.enable()
    acct = get_phase_accountant()
    acct.reset()
    acct.enable()
    zero_flash_launches()                    # the path starts here
    try:
        report = loadgen.run_scenario(eng, scenario, seed=0, **kw)
    finally:
        launches = flash_launches()          # and ends here
        acct.disable()
        acct.reset()
        obs.disable()
    return report, launches


def cost_ratios(report):
    """{program: measured over predicted} for the programs this run's
    engine measured (the registry keeps the gauge of a program no
    dispatch of this run observed at the 0 of its reset)."""
    return {k.removeprefix("program="): round(v, 4)
            for k, v in sorted(report["cost"]["ratio"].items()) if v > 0}


def headroom_median(report):
    """The median of the run's slo_headroom samples (None if none)."""
    hs = [s["headroom"] for s in report["timeline"]
          if s["headroom"] is not None]
    return statistics.median(hs) if hs else None


def loadgen_line(name, report, eng):
    """One line of a run's numbers, beside the card."""
    def q(block, key):
        v = block.get(key)
        return "not measured" if v is None else f"{v:.4f}"
    costs = {k: (None if c["seconds"] is None else round(c["seconds"], 6))
             for k, c in sorted((report["cost"]["programs"] or {}).items())}
    scales = {k: round(v, 4) for k, v in (eng._cost_scale or {}).items()}
    ad = report.get("adapters") or {}
    pfx = report.get("prefix") or {}
    log(f"loadgen {name} [{CARD}]: {report['schedule']['arrivals']} "
        f"arrivals, issued {report['issued']}, finished "
        f"{report['finished']}, goodput {report['goodput']}, goodput_rps "
        f"{report['goodput_rps']}, TTFT p50/p95 {q(report['ttft'], 'p50')}"
        f"/{q(report['ttft'], 'p95')} s, TPOT p50/p95 "
        f"{q(report['tpot'], 'p50')}/{q(report['tpot'], 'p95')} s, shed "
        f"{report['shed']}, headroom_floor {report['headroom_floor']}, "
        f"headroom median {headroom_median(report)}, scales {scales}, "
        f"predicted s {costs}, pir_cost_ratio {cost_ratios(report)}, "
        f"swap_recompiles "
        f"{ad.get('swap_recompiles')}, prefix hit rate "
        f"{pfx.get('hit_rate')}, brownout transitions "
        f"{report['brownout_transitions']}, wall {report['wall_s']} s")


def cost_ratio_problems(report):
    """The programs whose measured over predicted cost left the band, or
    a run with no measured program."""
    ratios = cost_ratios(report)
    lo, hi = COST_RATIO_BAND
    bad = {k: v for k, v in ratios.items() if not lo <= v <= hi}
    if not ratios:
        return ["no program's pir_cost_ratio was measured"]
    return [f"pir_cost_ratio outside [{lo}, {hi}]: {bad}"] if bad else []


def headroom_leads_shed(report):
    """The timeline samples where slo_headroom first reached <= 0 and
    where the shed fraction first passed 10% (None where it never did)."""
    tl = report["timeline"]
    over = next((i for i, s in enumerate(tl) if s["headroom"] is not None
                 and s["headroom"] <= 0.0), None)
    shed = next((i for i, s in enumerate(tl) if s["shed_frac"] > 0.10),
                None)
    return over, shed


def phase_loadgen(model):
    """Every scenario of inference/loadgen.py through the engine, then the
    chat sweep across saturation. Returns the sweep's rows."""
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    knobs = {"shared_prefix": dict(prefix_cache=True),
             # the ladder moves on the cost model's headroom alone, a rung
             # a step each way, so it can come back to 0 while the run
             # drains (check_report fails a run that ends degraded)
             "structured_output": dict(scheduler=SLOScheduler(
                 ttft_target=1e9, tpot_target=1e9, escalate_after=1,
                 recover_after=1, min_dwell=0))}
    for name in sorted(loadgen.SCENARIOS):
        adapters = loadgen.SCENARIOS[name].adapter_population > 0
        eng = loadgen_engine(model, warm=not adapters, **knobs.get(name, {}))
        report, launches = loadgen_run(eng, name,
                                       duration_s=LOADGEN_SECONDS)
        loadgen_line(name, report, eng)
        problems = loadgen.check_report(
            report,
            min_prefix_hit_rate=(MIN_PREFIX_HIT_RATE
                                 if name == "shared_prefix" else None),
            min_adapter_loads=MIN_ADAPTER_LOADS if adapters else None)
        problems += cost_ratio_problems(report)
        if launches:
            problems.append(f"{launches} K1-K4 launches in the engine run")
        if problems:
            sys.exit(f"chip_smoke: loadgen {name} failed its check: "
                     f"{problems}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    rows = []
    for rate in SWEEP_RATES:
        eng = loadgen_engine(model)
        report, launches = loadgen_run(eng, "chat", rate_rps=rate,
                                       duration_s=SWEEP_SECONDS,
                                       drain=False)
        loadgen_line(f"chat at {rate:g} rps", report, eng)
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        over, shed = headroom_leads_shed(report)
        attempts = report["issued"] + report["rejected"]
        # goodput as the share of the offered requests that finished good
        # inside the run (report["goodput"] counts finished requests
        # only, so a run that refuses or queues most of its traffic still
        # reads 1.0; here a refused request, and one still queued or in
        # flight when the run stops, counts against it)
        good = sum(report["finished"].get(r, 0)
                   for r in loadgen.GOOD_REASONS)
        rows.append(dict(rate=rate, goodput=good / max(1, attempts),
                         goodput_rps=report["goodput_rps"],
                         shed=report["shed"],
                         shed_frac=report["shed"] / max(1, attempts),
                         floor=report["headroom_floor"],
                         median=headroom_median(report)))
        log(f"loadgen sweep [{CARD}]: {rate:g} rps offered, goodput "
            f"{rows[-1]['goodput']:.4f} ({good} of {attempts} offered "
            f"requests finished good in the run), goodput_rps "
            f"{report['goodput_rps']}, TTFT p50 {report['ttft']['p50']} s, "
            f"shed {report['shed']} of {attempts} "
            f"({rows[-1]['shed_frac']:.4f}), headroom median "
            f"{rows[-1]['median']}, floor {rows[-1]['floor']}, headroom <= "
            f"0 at sample {over}, shed > 10% at sample {shed}")
        if shed is not None and (over is None or over > shed):
            sys.exit(f"chip_smoke: at {rate:g} rps the shed fraction "
                     f"passed 10% (sample {shed}) before slo_headroom "
                     f"reached 0 (sample {over})")
        if launches:
            sys.exit(f"chip_smoke: {launches} K1-K4 launches in the sweep")
        problems = cost_ratio_problems(report)
        if problems:
            sys.exit(f"chip_smoke: chat at {rate:g} rps: {problems}")
    ok = [r["rate"] for r in rows if r["goodput"] >= 0.95]
    log(f"loadgen sweep [{CARD}]: highest rate with goodput >= 0.95: "
        f"{max(ok) if ok else 'none'} rps; phase done in "
        f"{time.perf_counter() - t0:.1f} s")
    # the headroom must tell the rates apart, not only lead the shed: a
    # signal that called overload from the start of every run would pass
    # the onset check alone. Its median must be > 0 at the lowest rate,
    # about half the engine's saturated goodput_rps, and <= 0 at every
    # rate that sheds. The highest rate with goodput >= 0.95 is not held
    # to a sign: on the H100 it is 10 requests/s, the saturated rate
    # itself, where the true headroom is about 0
    shedding = [r for r in rows if r["shed_frac"] > 0.10]
    low = rows[0]
    wrong = ([low["rate"]] if low["median"] is None or low["median"] <= 0.0
             else []) + [r["rate"] for r in shedding
                         if r["median"] is None or r["median"] > 0.0]
    if not shedding or wrong:
        sys.exit(f"chip_smoke: slo_headroom does not separate the sweep's "
                 f"rates (median > 0 at {low['rate']:g} rps; <= 0 where "
                 f"shed > 10%: {[r['rate'] for r in shedding]}; wrong at "
                 f"{wrong})")
    return rows


def phase_predictor(model, decision):
    """llama_7b saved by jit.save and run by create_predictor on the card;
    returns K1's launches over the two runs. `decision` is the router's at
    the prefill shape (phase 6): each run launches K1 once per layer,
    through the flash_fwd operator, if its forward is the kernel."""
    cfg = model.config
    shape, dtype = PREDICTOR_SPEC
    ids = np.random.RandomState(0).randint(0, cfg.vocab_size, tuple(shape))
    gc.collect()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_predictor_")
    try:
        prefix = os.path.join(tmp, "llama_7b")
        t0 = time.perf_counter()
        jit.save(model, prefix, input_spec=[jit.InputSpec(shape, dtype)])
        save_s = time.perf_counter() - t0
        nbytes = {ext: os.path.getsize(prefix + ext)
                  for ext in (".pdmodel", ".pdiparams")}
        t0 = time.perf_counter()
        pred = inference.create_predictor(inference.Config(prefix))
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp)
    ops = sum(1 for n in pred._layer.program.graph.nodes
              if n.target == torch.ops.paddle_tpu_torch.flash_fwd.default)
    want = cfg.num_hidden_layers if decision.fwd == "pallas" else 0
    log(f"predictor [{CARD}]: saved in {save_s:.2f} s ({nbytes['.pdmodel']} "
        f"bytes of program, {nbytes['.pdiparams']} of params), loaded on "
        f"{pred._config._device} in {load_s:.2f} s; the program holds {ops} "
        f"flash_fwd nodes (router at the prefill shape: fwd={decision.fwd})")
    if ops != want:
        sys.exit(f"chip_smoke: the saved program holds {ops} flash_fwd "
                 f"nodes, expected {want}")
    handle = pred.get_input_handle(pred.get_input_names()[0])
    handle.copy_from_cpu(ids)
    torch.cuda.reset_peak_memory_stats()
    outs = []
    fa.flash_fwd_launches = 0                  # the main path starts here
    for _ in range(2):
        before = fa.flash_fwd_launches
        pred.run()
        outs.append(pred.get_output_handle("out0").copy_to_cpu())
        if fa.flash_fwd_launches - before != want:
            sys.exit(f"chip_smoke: a predictor run launched "
                     f"{fa.flash_fwd_launches - before} K1, expected {want}")
    launches = fa.flash_fwd_launches           # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    if not np.array_equal(outs[0], outs[1]):
        sys.exit("chip_smoke: two predictor runs disagree")
    ids_dev = torch.as_tensor(ids, device="cuda")
    with torch.no_grad():
        eager = model(ids_dev).float().cpu().numpy()
    if outs[0].shape != eager.shape or not np.isfinite(outs[0]).all():
        sys.exit(f"chip_smoke: predictor logits {outs[0].shape} are not "
                 f"finite logits of {eager.shape}")
    err = float(np.abs(outs[0] - eager).max() / np.abs(eager).max())
    with torch.no_grad():
        run_ms = profile_serving.median_ms(pred.run, lambda: None)
        eager_ms = profile_serving.median_ms(
            lambda: model(ids_dev).float().cpu(), lambda: None)
    log(f"predictor [{CARD}]: logits against the eager forward: max err / "
        f"max|logit| {err:.3e} (tol {PREDICTOR_LOGITS_RTOL}), runs equal; "
        f"K1 launches {launches} over 2 runs; run {run_ms:.3f} ms, eager "
        f"forward {eager_ms:.3f} ms (CUDA events, median of 5, each with "
        f"the logits' copy to the host); peak memory {peak / 2**30:.2f} GiB")
    if not err <= PREDICTOR_LOGITS_RTOL:
        sys.exit("chip_smoke: predictor logits disagree with the eager "
                 "forward")
    del pred
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_epilogue(decisions):
    """incubate's fused_attention_rms_epilogue at the serving prefill and
    training attention shapes (forward only); returns K2's launches over
    the two calls. Each call launches K2 once where the ledger marks the
    fusion a winner, else never; its output is held against the unfused
    composition (dense attention, then the epilogue in torch)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(4)
    launches = 0
    for i, (name, case) in enumerate((("prefill", PREFILL),
                                      ("train", TRAIN_ATTN))):
        (q, k, v), _, _ = case_inputs(case, gen)
        res, w = epilogue_inputs(case, 200 + i)
        fa.flash_fwd_rms_epilogue_launches = 0     # the path starts here
        with torch.inference_mode():
            t0 = time.perf_counter()
            out = IF.fused_attention_rms_epilogue(q, k, v, res, w,
                                                  epsilon=RMS_EPS)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        launched = fa.flash_fwd_rms_epilogue_launches   # and ends here
        launches += launched
        want = 1 if decisions[name][1] else 0
        with torch.inference_mode():
            kx, vx = IF._expand_gqa(k, v, case["h"])
            ref = torch_epilogue(IF._sdpa_dense(q, kx, vx, case["causal"]),
                                 res, w).float()
        got = out.float()
        gmax = w.abs().max().item()
        err = (got - ref).abs().max().item()
        ok = (out.shape == q.shape and out.dtype == q.dtype
              and bool(torch.isfinite(got).all())
              and bool(((got - ref).abs() <= K2_ATOL * gmax
                        + K2_RTOL * ref.abs()).all()))
        log(f"fused_attention_rms_epilogue {case_name(case)}: "
            f"{tuple(out.shape)} in {secs * 1e3:.3f} ms, K2 launches "
            f"{launched} (expected {want}), max|err| vs unfused "
            f"{err:.3e} {'ok' if ok else 'FAIL'}")
        if launched != want:
            sys.exit(f"chip_smoke: {launched} K2 launches in one "
                     f"fused_attention_rms_epilogue call, expected {want}")
        if not ok:
            sys.exit("chip_smoke: fused_attention_rms_epilogue disagrees "
                     "with the unfused composition")
    return launches


def phase_tiny_train():
    """The training step of a tiny llama (GQA, head dim 32: padded to 64
    where the router picks the kernels) in bf16 on the card against the
    same weights in f32 on the CPU: the loss, every gradient, and one AdamW
    step (moments and parameters)."""
    pt.seed(2)
    gpu = pt.models.llama_tiny(dtype="bfloat16", device="cuda")
    cpu = pt.models.llama_tiny(device="cpu")
    cpu.load_state_dict({k: v.float().cpu()
                         for k, v in gpu.state_dict().items()})
    ids = np.random.RandomState(2).randint(0, 512, (2, 128))
    runs = []
    for model in (gpu, cpu):
        params, loss_fn = build_scanned_llama(model, remat=True)
        opt = optimizer.AdamW(TINY_LR, parameters=model.parameters())
        state = opt.tree_init(params)
        x = torch.as_tensor(ids, device=next(iter(params["embed"].values()))
                            .device)
        loss = loss_fn(params, x, x)
        loss.backward()
        grads = {k: {n: t.grad for n, t in group.items()}
                 for k, group in params.items()}
        opt.tree_update(params, grads, state, TINY_LR, 1)
        runs.append((loss.item(), grads, state, params))
    (l_gpu, g_gpu, s_gpu, p_gpu), (l_cpu, g_cpu, s_cpu, p_cpu) = runs
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = moment_err = 0.0
    params_ok = True
    for group in g_cpu:
        for n, ref in g_cpu[group].items():
            scale = ref.abs().max().item() or 1.0
            grad_err = max(grad_err, (g_gpu[group][n].float().cpu() - ref)
                           .abs().max().item() / scale)
            m_ref = s_cpu[group][n]["moment1"]
            m_scale = m_ref.abs().max().item() or 1.0
            moment_err = max(moment_err, (s_gpu[group][n]["moment1"].float()
                                          .cpu() - m_ref).abs().max().item()
                             / m_scale)
            want = p_cpu[group][n].detach()
            got = p_gpu[group][n].detach().float().cpu()
            params_ok &= bool(((got - want).abs() <= 2 * TINY_LR + 2 ** -7
                               * torch.maximum(got.abs(), want.abs())).all())
    ok = (loss_err <= TINY_LOSS_RTOL and grad_err <= TINY_GRAD_RTOL
          and moment_err <= TINY_GRAD_RTOL and params_ok)
    log(f"tiny llama training step, bf16 on card vs f32 on CPU: loss "
        f"{l_gpu:.5f} vs {l_cpu:.5f} (rel err {loss_err:.2e}, tol "
        f"{TINY_LOSS_RTOL}); max grad err/max|grad| {grad_err:.2e}, "
        f"moment1 {moment_err:.2e} (tol {TINY_GRAD_RTOL}); params after "
        f"AdamW within 2 lr + 2^-7 |p|: {params_ok} {'ok' if ok else 'FAIL'}")
    if not ok:
        sys.exit("chip_smoke: the tiny training step on the card disagrees "
                 "with the CPU")
    # the tiny models' shapes miss the ledger: the router timed them here
    for key, dec in ar.decision_log():
        if dec.source == "measured-cuda":
            log(f"router {key}: fwd={dec.fwd} bwd={dec.bwd}, "
                f"{dec.provenance}")


def phase_train(decision):
    """llama_1.3b trained through train_llama.run_one; returns each kernel's
    launches over the run. `decision` is the router's at the training
    attention shape, which sets the launches each step must make."""
    gc.collect()
    torch.cuda.empty_cache()
    name, cfg, batch, seq, steps, remat = train_llama.llama_ladder()[0]
    n_layers = cfg.num_hidden_layers
    # the training path starts here
    fa.flash_fwd_launches = fa.flash_bwd_dq_launches = 0
    fa.flash_bwd_dkv_launches = 0
    r = train_llama.run_one(cfg, batch, seq, steps, remat,
                            loss_chunk_mb=train_llama.loss_chunk_mb_for(name),
                            device="cuda")
    launches = train_llama.launch_counts()     # the training path ends here
    secs = r["seconds"]
    log(f"train {name}: {r['n_params']} params, {n_layers} layers, b{batch} "
        f"s{seq}, remat {remat}, loss path {r['lm_loss_path']}; set-up "
        f"{secs['setup']:.2f} s, warm-up step {secs['warmup']:.2f} s, "
        f"{steps} steps {secs['steps']:.2f} s")
    log(f"train {name}: step {r['step_time_s'] * 1e3:.1f} ms, "
        f"{r['tokens_per_s']:.1f} tokens/s, MFU {r['mfu']:.4f}, peak memory "
        f"{r['peak_memory_bytes'] / 2**30:.2f} GiB, launches {launches}")
    log(f"train {name}: losses {r['losses']}")
    fwd = decision.fwd == "pallas"
    bwd = fwd and decision.bwd == "pallas"
    want = {"flash_fwd": 2 * n_layers if fwd else 0,
            "flash_bwd_dq": n_layers if bwd else 0,
            "flash_bwd_dkv": n_layers if bwd else 0}
    if not all(np.isfinite(r["losses"])):
        sys.exit("chip_smoke: a training loss is not finite")
    if not r["losses"][-1] < r["losses"][0]:
        sys.exit("chip_smoke: the training loss did not fall")
    if r["lm_loss_path"] != "chunked":
        sys.exit("chip_smoke: llama_1.3b at b8 s2048 must take the chunked "
                 "LM loss")
    for i, per_step in enumerate(r["launches_per_step"]):
        if per_step != want:
            sys.exit(f"chip_smoke: step {i + 2} launched {per_step}, "
                     f"expected {want}")
    return launches


def phase_bert(decision):
    """BERT-base pretraining (bench.py's configuration) through
    train_bert.run_one; returns each kernel's launches over the run and
    the step's ms.
    `decision` is the router's at BERT's attention shape: each step
    launches K1 once per layer if its forward is the kernel, and K3 and K4
    once per layer if its backward is too. Then the same steps under
    FLAGS_flash_attention_backend=xla, the dense A/B: no kernel launch, and
    the first step's loss within BERT_LOSS_RTOL of the routed run's."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq, steps, dtype = train_bert.bench_config("cuda")
    n_layers = cfg.num_hidden_layers
    zero_flash_launches()                      # the BERT path starts here
    r = train_bert.run_one(cfg, batch, seq, steps, dtype, device="cuda")
    launches = train_llama.launch_counts()     # the BERT path ends here
    gc.collect()
    torch.cuda.empty_cache()
    train = train_bert.TrainStep(cfg, batch, seq, dtype, "cuda")
    train.step(1)
    by_class = kernel_ms_by_class(lambda: train.step(2))
    log(f"bert_base routed, one traced step: {class_line(by_class)}; busy "
        f"{sum(by_class.values()) / r['step_ms']:.1%} of the "
        f"timed steps' mean")
    del train
    gc.collect()
    torch.cuda.empty_cache()
    pt.set_flags({"FLAGS_flash_attention_backend": "xla"})
    try:
        zero_flash_launches()
        dense = train_bert.run_one(cfg, batch, seq, steps, dtype,
                                   device="cuda")
        dense_launches = flash_launches()
    finally:
        pt.set_flags({"FLAGS_flash_attention_backend": "auto"})
    for name, run in (("routed", r), ("dense", dense)):
        secs = run["seconds"]
        log(f"bert_base {name}: {run['bert_params']} params, {n_layers} "
            f"layers, b{batch} s{seq} {dtype}; set-up {secs['setup']:.2f} "
            f"s, warm-up step {secs['warmup']:.2f} s; step "
            f"{run['step_ms']:.2f} ms, "
            f"{run['bert_tokens_per_s']:.1f} tokens/s, MFU "
            f"{run['bert_base_mfu']:.4f}, peak memory "
            f"{run['peak_memory_bytes'] / 2**30:.2f} GiB, launches per "
            f"step {run['launches_per_step'][-1]}")
        log(f"bert_base {name}: losses {run['losses']}")
    loss_err = abs(r["losses"][0] - dense["losses"][0]) / abs(
        dense["losses"][0])
    log(f"bert_base: routed/dense step-1 loss rel err {loss_err:.3e} (tol "
        f"{BERT_LOSS_RTOL}); step time routed/dense "
        f"{r['step_ms'] / dense['step_ms']:.3f}; router at the shape: "
        f"fwd={decision.fwd} bwd={decision.bwd} source={decision.source}; "
        f"launches over the routed run {launches}")
    fwd = decision.fwd == "pallas"
    bwd = fwd and decision.bwd == "pallas"
    want = {"flash_fwd": n_layers if fwd else 0,
            "flash_bwd_dq": n_layers if bwd else 0,
            "flash_bwd_dkv": n_layers if bwd else 0}
    if not all(np.isfinite(r["losses"] + dense["losses"])):
        sys.exit("chip_smoke: a BERT training loss is not finite")
    if not r["losses"][-1] < r["losses"][0]:
        sys.exit("chip_smoke: the BERT training loss did not fall")
    for i, per_step in enumerate(r["launches_per_step"]):
        if per_step != want:
            sys.exit(f"chip_smoke: BERT step {i + 2} launched {per_step}, "
                     f"expected {want}")
    if dense_launches:
        sys.exit("chip_smoke: the dense BERT run launched a flash kernel")
    if not loss_err <= BERT_LOSS_RTOL:
        sys.exit("chip_smoke: BERT's first loss under the routed attention "
                 "disagrees with the dense backend's")
    return launches, r["step_ms"]


def phase_gpt():
    """gpt3_1p3b (bf16, random weights from seed(0)) generating greedily
    through the recompute path; returns K1's launches over the timed call.
    The first call is the warm-up: on a ledger miss the router measures
    each new causal length live (the reference keys on the exact length).
    The timed second call must launch K1 once per layer for every length
    routed to the kernel and give the warm-up's ids; the last forward's
    logits must agree with the dense backend's within GPT_LOGITS_RTOL of
    the largest |logit|."""
    gc.collect()
    torch.cuda.empty_cache()
    pt.seed(0)
    t0 = time.perf_counter()
    model = pt.models.gpt3_1p3b(dtype="bfloat16", device="cuda")
    model.eval()
    torch.cuda.synchronize()
    cfg = model.config
    heads, n_layers = cfg.num_attention_heads, cfg.num_hidden_layers
    log(f"gpt3_1p3b: {model.num_params()} params, {n_layers} layers, "
        f"hidden {cfg.hidden_size}, {heads} heads, vocab {cfg.vocab_size}, "
        f"built in {time.perf_counter() - t0:.2f} s")
    b, s, new = GPT_BATCH, GPT_PROMPT, GPT_NEW
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (b, s)), device="cuda")
    t0 = time.perf_counter()
    warm = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    fa.flash_fwd_launches = 0                  # the GPT path starts here
    t0 = time.perf_counter()
    out = model.generate(ids, max_new_tokens=new)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = fa.flash_fwd_launches           # the GPT path ends here
    peak = torch.cuda.max_memory_allocated()
    hd = cfg.hidden_size // heads
    decisions = {n: ar.route(b * heads, n, n, hd, torch.bfloat16, True)
                 for n in range(s, s + new)}
    sources = {}
    for n, dec in decisions.items():
        sources.setdefault((dec.source, dec.fwd), []).append(n)
    want = n_layers * sum(dec.fwd == "pallas" for dec in decisions.values())
    log(f"gpt3_1p3b generate b{b} prompt {s} new {new}: warm-up "
        f"{warm_s * 1e3:.1f} ms, timed {secs * 1e3:.1f} ms, "
        f"{b * new / secs:.1f} tokens/s, K1 launches {launches} (expected "
        f"{want}), peak memory {peak / 2**30:.2f} GiB")
    for (source, fwd), lengths in sorted(sources.items()):
        log(f"  router: lengths {lengths[0]}-{lengths[-1]} "
            f"({len(lengths)}) fwd={fwd} source={source}")
    log(f"  e.g. length {s}: {decisions[s].provenance}")
    last = out[:, :-1]
    with torch.inference_mode():
        by_class = kernel_ms_by_class(lambda: model(last))
        got = model(last).float()
        pt.set_flags({"FLAGS_flash_attention_backend": "xla"})
        try:
            ref = model(last).float()
        finally:
            pt.set_flags({"FLAGS_flash_attention_backend": "auto"})
    log(f"  last forward (b{b} s{last.shape[1]}) traced: "
        f"{class_line(by_class)}")
    err = (got - ref).abs().max().item() / ref.abs().max().item()
    log(f"  last forward's logits routed vs dense: max|err|/max|logit| "
        f"{err:.3e} (tol {GPT_LOGITS_RTOL})")
    if out.shape != (b, s + new) or not torch.equal(out[:, :s], ids):
        sys.exit("chip_smoke: GPT generate returned a wrong shape or prompt")
    if out.min().item() < 0 or out.max().item() >= cfg.vocab_size:
        sys.exit("chip_smoke: a GPT token id is out of the vocabulary")
    if not torch.equal(out, warm):
        sys.exit("chip_smoke: two greedy GPT runs disagree")
    if launches != want:
        sys.exit(f"chip_smoke: {launches} K1 launches in one GPT generate, "
                 f"expected {want}")
    if not (torch.isfinite(got).all() and err <= GPT_LOGITS_RTOL):
        sys.exit("chip_smoke: GPT logits under the routed attention "
                 "disagree with the dense backend's")
    return launches


def check_f32(ctor, hw, batch):
    """max |output difference| / max |output| of a float32 `ctor()`'s
    training-mode forward (dropout off) of `batch` images on the card
    against the same weights and images on the CPU, over every output."""
    pt.seed(0)
    cpu = ctor(device="cpu")
    card = ctor(device="cpu").to("cuda")
    card.load_state_dict(cpu.state_dict())
    for m in (cpu, card):
        m.train()
        for sub in m.modules():
            if isinstance(sub, Dropout):
                sub.eval()
    x = torch.as_tensor(np.random.RandomState(1).randn(batch, 3, hw, hw),
                        dtype=torch.float32)
    with torch.no_grad():
        want = cpu(x)
        got = card(x.cuda())
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    return max(((g.cpu() - w).abs().max() / w.abs().max()).item()
               for g, w in zip(got, want))


def resnet_tuned():
    """{"first_s": the first step's seconds, "by_class": kernel_ms_by_class
    of the third} of the bf16 ResNet step with cuDNN's autotuner on, in a
    fresh process: a process's cached convolution plans outlive the
    flag, so this one's would keep the untuned algorithms."""
    code = ("import json, time, torch, chip_smoke as c\n"
            "from paddle_tpu_torch.tools import train_resnet as t\n"
            "torch.backends.cudnn.benchmark = True\n"
            "s = t.TrainStep(t.bench_config('cuda'), 'cuda')\n"
            "t0 = time.perf_counter(); s.step(1); torch.cuda.synchronize()\n"
            "first = time.perf_counter() - t0; s.step(2)\n"
            "print(json.dumps({'first_s': first, 'by_class': "
            "c.kernel_ms_by_class(lambda: s.step(3), c.resnet_class)}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    if out.returncode:
        sys.exit(f"chip_smoke: the autotuned ResNet step failed:\n"
                 f"{out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def resnet_line(name, r):
    secs = r["seconds"]
    log(f"resnet50 {name}: {r['resnet_params']} params, b"
        f"{r['resnet_batch']} 224x224; set-up {secs['setup']:.2f} s, "
        f"warm-up step {secs['warmup']:.2f} s; step {r['step_ms']:.2f} ms, "
        f"{r['resnet_images_per_s']:.1f} images/s, resnet_mfu "
        f"{r['resnet_mfu']:.4f} ({r['flops_per_step'] / 1e12:.4f} TFLOP a "
        f"step), peak memory {r['peak_memory_bytes'] / 2**30:.2f} GiB")
    log(f"resnet50 {name}: losses {r['losses']}")


def phase_resnet():
    """ResNet-50 training as bench.py's `_bench_resnet` measures it, through
    train_resnet.run_one (cuDNN's autotuner off, torch's default); returns
    the flash kernels' launches over the run (none is on this path). Then
    the float32 model's steps, one bf16 step traced with the autotuner off
    and one with it on, and the float32 forward against the CPU's."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg = train_resnet.bench_config("cuda")
    zero_flash_launches()                      # the ResNet path starts here
    r = train_resnet.run_one(cfg, device="cuda")
    launches = train_llama.launch_counts()     # the ResNet path ends here
    k2 = fa.flash_fwd_rms_epilogue_launches
    gc.collect()
    torch.cuda.empty_cache()
    f32 = train_resnet.run_one(cfg._replace(dtype="float32"), device="cuda")
    train = train_resnet.TrainStep(cfg, "cuda")
    train.step(1)
    kernels = []
    by_class = kernel_ms_by_class(lambda: train.step(2), resnet_class,
                                  kernels)
    del train
    gc.collect()
    torch.cuda.empty_cache()
    tuned = resnet_tuned()
    resnet_line("bf16", r)
    resnet_line("float32 (TF32 off)", f32)
    conv = "convolutions (cuDNN)"
    log(f"resnet50 bf16, one traced step: {class_line(by_class)}; busy "
        f"{sum(by_class.values()) / r['step_ms']:.1%} of the timed steps' "
        f"mean; the largest kernels: " + "; ".join(
            f"{name[:60]} x{n} {ms:.3f} ms ({resnet_class(name)})"
            for ms, n, name in sorted(kernels, reverse=True)[:8]))
    log(f"resnet50 bf16 with cudnn.benchmark on, in a fresh process (its "
        f"first step {tuned['first_s']:.2f} s), one traced step: "
        f"{class_line(tuned['by_class'])}; convolutions "
        f"{tuned['by_class'].get(conv, 0.0):.3f} ms against "
        f"{by_class.get(conv, 0.0):.3f} ms with it off")
    gc.collect()
    torch.cuda.empty_cache()
    f32_err = check_f32(cfg.ctor, cfg.hw, RESNET_CHECK_BATCH)
    loss_err = abs(r["losses"][0] - f32["losses"][0]) / abs(f32["losses"][0])
    log(f"resnet50: float32 logits card vs CPU (b{RESNET_CHECK_BATCH}, TF32 "
        f"off) max|err|/max|logit| {f32_err:.3e} (tol {RESNET_F32_RTOL}); "
        f"bf16 first loss {r['losses'][0]:.6f} vs float32 "
        f"{f32['losses'][0]:.6f}, rel err {loss_err:.3e} (tol "
        f"{RESNET_BF16_LOSS_RTOL}); running stats finite "
        f"{r['running_stats_finite']}, stem mean max|.| "
        f"{r['stem_mean_absmax']:.4g}; launches over the run {launches}, K2 "
        f"{k2}")
    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    for run in (r, f32):
        if not all(np.isfinite(run["losses"])):
            sys.exit("chip_smoke: a ResNet training loss is not finite")
        if not run["losses"][1] < run["losses"][0]:
            sys.exit("chip_smoke: the first ResNet update did not lower "
                     "the loss")
        if any(step != zero for step in run["launches_per_step"]):
            sys.exit("chip_smoke: a ResNet step launched a flash kernel")
        if not (run["running_stats_finite"]
                and run["stem_mean_absmax"] > 0):
            sys.exit("chip_smoke: ResNet's running statistics are not "
                     "finite or did not move")
    if k2 or launches != zero:
        sys.exit("chip_smoke: the ResNet run launched a flash kernel")
    if not f32_err <= RESNET_F32_RTOL:
        sys.exit("chip_smoke: ResNet-50's float32 logits on the card "
                 "disagree with the CPU's")
    if not loss_err <= RESNET_BF16_LOSS_RTOL:
        sys.exit("chip_smoke: ResNet-50's bf16 first loss disagrees with "
                 "the float32 model's")
    return launches


def depthwise_kernel_names():
    """The convolution kernels a depthwise convolution's forward and
    backward launch and a dense one's do not: bf16 at MobileNetV2's shapes
    (144 channels at 56 x 56 stride 1 and 2, 960 at 7 x 7), b64. The
    probe's other kernels (casts, fills, reductions) stay in their own
    classes. (A kernel whose name says "depthwise", torch's own
    conv_depthwise2d, is one whatever the probe sees.)"""
    names = set()
    for c, hw, stride in ((144, 56, 1), (144, 56, 2), (960, 7, 1)):
        x = torch.randn(64, c, hw, hw, device="cuda", dtype=torch.bfloat16,
                        requires_grad=True)
        w_dw = torch.randn(c, 1, 3, 3, device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)
        w_pw = torch.randn(c, c, 1, 1, device="cuda", dtype=torch.bfloat16,
                           requires_grad=True)

        def launched(fn):
            fn()                       # warm: the traced call is steady
            kernels = []
            kernel_ms_by_class(fn, kernels=kernels)
            return {name for _, _, name in kernels}
        dw = launched(lambda: torch.nn.functional.conv2d(
            x, w_dw, stride=stride, padding=1, groups=c).float().sum()
            .backward())
        dense = launched(lambda: torch.nn.functional.conv2d(
            x, w_pw, stride=stride).float().sum().backward())
        names |= {n for n in dw - dense
                  if resnet_class(n) == "convolutions (cuDNN)"}
    return names


def zoo_line(name, r):
    secs = r["seconds"]
    macs = r["flops_per_step"] / (6 * r["resnet_batch"])
    log(f"{r['resnet_variant']} {name}: {r['resnet_params']} params, "
        f"{macs / 1e9:.4f} GMAC an image, b"
        f"{r['resnet_batch']}; set-up {secs['setup']:.2f} s, warm-up step "
        f"{secs['warmup']:.2f} s; step {r['step_ms']:.2f} ms, "
        f"{r['resnet_images_per_s']:.1f} images/s, mfu "
        f"{r['resnet_mfu']:.4f} ({r['flops_per_step'] / 1e12:.4f} TFLOP a "
        f"step), peak memory {r['peak_memory_bytes'] / 2**30:.2f} GiB; "
        f"losses {r['losses']} [{CARD}]")


def zoo_ops():
    """The new ops on the card against the CPU (see ZOO_* above); prints
    each one's median time and error."""
    rs = np.random.RandomState(0)

    def on_both(fn, *args):
        cpu = fn(*[a.cpu() if torch.is_tensor(a) else a for a in args])
        card = fn(*[a.cuda() if torch.is_tensor(a) else a for a in args])
        torch.cuda.synchronize()
        ms = time_ms(lambda: fn(*[a.cuda() if torch.is_tensor(a) else a
                                  for a in args]), reps=5, warmup=1)
        return cpu, card, ms

    def rel(card, cpu):
        return ((card.float().cpu() - cpu.float()).abs().max()
                / cpu.float().abs().max()).item()
    problems = []

    def check(label, err, tol, ms):
        log(f"zoo op {label}: max|err|/max|value| {err:.3e} (tol {tol}), "
            f"{ms:.3f} ms median [{CARD}]")
        if not err <= tol:
            problems.append(label)
    x = torch.as_tensor(rs.randn(8, 256, 64, 64), dtype=torch.float32)
    w = torch.as_tensor(rs.randn(256, 128, 4, 4) / 64, dtype=torch.float32)
    b = torch.as_tensor(rs.randn(128), dtype=torch.float32)
    tconv = (lambda a, k, c: PF.conv2d_transpose(a, k, c, stride=2,
                                                 padding=1))
    cpu, card, ms = on_both(tconv, x, w, b)
    assert card.shape == (8, 128, 128, 128)
    check("conv2d_transpose f32 b8 256->128 64x64 k4 s2 p1",
          rel(card, cpu), ZOO_OPS_F32_RTOL, ms)
    xb, wb, bb = x.bfloat16(), w.bfloat16(), b.bfloat16()
    cpu = tconv(xb.float(), wb.float(), bb.float())
    _, card, ms = on_both(tconv, xb, wb, bb)
    check("conv2d_transpose bf16 (against float32 of the bf16 inputs)",
          rel(card, cpu), ZOO_OPS_BF16_RTOL, ms)
    same = (lambda a, k: PF.conv2d_transpose(a, k, stride=3,
                                             padding="SAME"))
    w2 = torch.as_tensor(rs.randn(256, 128, 2, 2) / 32, dtype=torch.float32)
    cpu, card, ms = on_both(same, x, w2)
    assert card.shape == (8, 128, 192, 192)
    check("conv2d_transpose SAME k2 s3 (kernel < stride)", rel(card, cpu),
          ZOO_OPS_F32_RTOL, ms)

    relu = torch.relu(torch.as_tensor(rs.randn(8, 128, 112, 112),
                                      dtype=torch.float32))
    pool = (lambda a: PF.max_pool2d(a, 2, 2, return_mask=True))
    (cpu_out, cpu_idx), (card_out, card_idx), ms = on_both(pool, relu)
    un = (lambda a, i: PF.max_unpool2d(a, i, 2, 2))
    cpu_un, card_un, ms_un = on_both(un, cpu_out, cpu_idx)
    exact = (torch.equal(card_idx.cpu(), cpu_idx)
             and torch.equal(card_out.cpu(), cpu_out)
             and torch.equal(card_un.cpu(), cpu_un))
    ties = int((relu == 0).sum())
    log(f"zoo op max_pool2d(return_mask) + max_unpool2d on a ReLU'd "
        f"8x128x112x112 ({ties} zeros): indices and values equal {exact}; "
        f"{ms:.3f} + {ms_un:.3f} ms median [{CARD}]")
    if not exact:
        problems.append("max_pool2d mask / max_unpool2d")

    feat = torch.as_tensor(rs.randn(2, 256, 200, 304), dtype=torch.float32)
    xy = rs.uniform(0, 280, (512, 2))
    wh = rs.uniform(4, 120, (512, 2))
    boxes = torch.as_tensor(np.concatenate([xy, xy + wh], 1) * 4,
                            dtype=torch.float32)
    num = torch.tensor([256, 256], dtype=torch.int32)
    ra = (lambda f, bx, n: V.roi_align(f, bx, n, 7, spatial_scale=0.25,
                                       sampling_ratio=2))
    cpu, card, ms = on_both(ra, feat, boxes, num)
    check("roi_align 2x256x200x304 512 boxes 7x7 sr2", rel(card, cpu),
          ZOO_OPS_F32_RTOL, ms)

    img = torch.as_tensor(rs.randn(2, 64, 64, 64), dtype=torch.float32)
    off = torch.as_tensor(rs.randn(2, 18, 64, 64), dtype=torch.float32)
    mask = torch.as_tensor(rs.rand(2, 9, 64, 64), dtype=torch.float32)
    wd = torch.as_tensor(rs.randn(64, 64, 3, 3) / 24, dtype=torch.float32)
    for label, m in (("", ()), (" with a mask", (mask,))):
        dc = (lambda a, o, k, *mm: V.deform_conv2d(
            a, o, k, padding=1, mask=mm[0] if mm else None))
        cpu, card, ms = on_both(dc, img, off, wd, *m)
        check(f"deform_conv2d 2x64x64x64 3x3{label}", rel(card, cpu),
              ZOO_OPS_F32_RTOL, ms)

    xy = rs.uniform(0, 600, (1000, 2))
    nb = torch.as_tensor(np.concatenate(
        [xy, xy + rs.uniform(10, 200, (1000, 2))], 1), dtype=torch.float32)
    sc = torch.as_tensor(rs.rand(1000), dtype=torch.float32)
    cpu, card, ms = on_both(lambda bx, s: V.nms(bx, 0.5, s), nb, sc)
    same_keep = torch.equal(card.cpu(), cpu)
    log(f"zoo op nms 1000 boxes: {len(cpu)} kept, equal to the CPU's "
        f"{same_keep}; {ms:.3f} ms median (host numpy) [{CARD}]")
    if not same_keep:
        problems.append("nms")
    return problems


def phase_zoo():
    """The vision zoo (phase 18): MobileNetV2 training, every other
    family's flagship, the new ops; returns the flash kernels' launches
    over the phase (none is on this path)."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    dw_names = depthwise_kernel_names()

    def zoo_class(name):
        depthwise = name in dw_names or "depthwise" in name.lower()
        return ZOO_DEPTHWISE if depthwise else resnet_class(name)

    def traced_step(cfg):
        """kernel_ms_by_class of the third bf16 step of cfg's TrainStep,
        and its kernels' (ms, launches, name)."""
        train = train_resnet.TrainStep(cfg, "cuda")
        train.step(1)
        kernels = []
        by_class = kernel_ms_by_class(lambda: train.step(2), zoo_class,
                                      kernels)
        del train
        gc.collect()
        torch.cuda.empty_cache()
        return by_class, kernels
    cfg = train_resnet.zoo_config("mobilenet_v2", "cuda")
    zero_flash_launches()                      # the zoo path starts here
    r = train_resnet.run_one(cfg, device="cuda")
    gc.collect()
    torch.cuda.empty_cache()
    f32 = train_resnet.run_one(cfg._replace(dtype="float32"), steps=1,
                               device="cuda")
    by_class, kernels = traced_step(cfg)
    zoo_line("mobilenet_v2 bf16", r)
    zoo_line("mobilenet_v2 float32 (TF32 off)", f32)
    log(f"mobilenet_v2 bf16, one traced step: {class_line(by_class)}; busy "
        f"{sum(by_class.values()) / r['step_ms']:.1%} of the timed steps' "
        f"mean; {len(dw_names)} depthwise kernel names; the largest "
        f"kernels: " + "; ".join(
            f"{name[:60]} x{n} {ms:.3f} ms ({zoo_class(name)})"
            for ms, n, name in sorted(kernels, reverse=True)[:8]))
    f32_err = check_f32(cfg.ctor, cfg.hw, RESNET_CHECK_BATCH)
    loss_err = abs(r["losses"][0] - f32["losses"][0]) / abs(f32["losses"][0])
    log(f"mobilenet_v2: float32 logits card vs CPU (b{RESNET_CHECK_BATCH}, "
        f"TF32 off) max|err|/max|logit| {f32_err:.3e} (tol "
        f"{RESNET_F32_RTOL}); bf16 first loss {r['losses'][0]:.6f} vs "
        f"float32 {f32['losses'][0]:.6f}, rel err {loss_err:.3e} (tol "
        f"{RESNET_BF16_LOSS_RTOL}); running stats finite "
        f"{r['running_stats_finite']}, stem mean max|.| "
        f"{r['stem_mean_absmax']:.4g}")
    zero = {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    problems = []
    if not all(np.isfinite(r["losses"] + f32["losses"])):
        problems.append("a MobileNetV2 loss is not finite")
    if not r["losses"][1] < r["losses"][0]:
        problems.append("the first MobileNetV2 update did not lower the "
                        "loss")
    if not (r["running_stats_finite"] and r["stem_mean_absmax"] > 0):
        problems.append("MobileNetV2's running statistics are not finite "
                        "or did not move")
    if not f32_err <= RESNET_F32_RTOL:
        problems.append("MobileNetV2's float32 logits on the card "
                        "disagree with the CPU's")
    if not loss_err <= RESNET_BF16_LOSS_RTOL:
        problems.append("MobileNetV2's bf16 first loss disagrees with the "
                        "float32 model's")
    runs = [r, f32]
    for name in ZOO_FLAGSHIPS:
        gc.collect()
        torch.cuda.empty_cache()
        zcfg = train_resnet.zoo_config(name, "cuda")
        z = train_resnet.run_one(zcfg, steps=ZOO_STEPS, device="cuda")
        gc.collect()
        torch.cuda.empty_cache()
        err = check_f32(zcfg.ctor, zcfg.hw, ZOO_CHECK_BATCH)
        zoo_line(name, z)
        if name == "densenet121":
            dense, kernels = traced_step(zcfg)
            cat = [(ms, n) for ms, n, k in kernels if "CatArray" in k]
            log(f"densenet121 bf16, one traced step: {class_line(dense)}; "
                f"busy {sum(dense.values()) / z['step_ms']:.1%} of the "
                f"timed steps' mean; torch.cat's kernels (CatArrayBatched"
                f"Copy) {sum(ms for ms, _ in cat):.3f} ms in "
                f"{sum(n for _, n in cat)} launches")
        log(f"{name}: float32 outputs card vs CPU (b{ZOO_CHECK_BATCH}, TF32 "
            f"off) max|err|/max|value| {err:.3e} (tol {RESNET_F32_RTOL})")
        runs.append(z)
        if not np.isfinite(z["losses"]).all():
            problems.append(f"a {name} loss is not finite")
        if not err <= RESNET_F32_RTOL:
            problems.append(f"{name}'s float32 outputs on the card "
                            f"disagree with the CPU's")
    gc.collect()
    torch.cuda.empty_cache()
    problems += zoo_ops()
    launches = train_llama.launch_counts()     # the zoo path ends here
    k2 = fa.flash_fwd_rms_epilogue_launches
    if k2 or launches != zero or any(
            step != zero for run in runs for step in run["launches_per_step"]):
        problems.append("the zoo phase launched a flash kernel")
    log(f"vision zoo phase: launches over it {launches}, K2 {k2}; "
        f"{time.perf_counter() - t0:.1f} s [{CARD}]")
    if problems:
        sys.exit("chip_smoke: vision zoo: " + "; ".join(problems))
    return launches


# bench.py's decode configuration's int8 snapshot by the reference's
# formula (int8 layers and head, float32 scales, bf16 norms and embedding)
DECODE_INT8_WEIGHT_MB = 574.3
# llm_int8_linear on the card against the CPU, exactly: (tokens, k, n,
# outlier columns); the first has at most 16 rows, the second k and n that
# are no multiples of 8 (cuBLASLt's int8 GEMM wants both padded)
LLM_INT8_CASES = ((8, 2048, 5504, 1), (39, 1001, 515, 0))


def llm_int8_on_card():
    """weight_quantize and llm_int8_linear on the card equal their CPU
    results bit for bit (one outlier column at most, so the float32 outlier
    product sums one nonzero term)."""
    rs = np.random.RandomState(17)
    for m, k, n, outliers in LLM_INT8_CASES:
        x = rs.randn(1, m, k).astype(np.float32)
        x[0, 0, :outliers] = 40.0
        w = rs.randn(k, n).astype(np.float32)
        bias = rs.randn(n).astype(np.float32)
        q, sc = quant.weight_quantize(torch.as_tensor(w, device="cuda"),
                                      algo="llm.int8")
        qc, sc_c = quant.weight_quantize(torch.as_tensor(w), algo="llm.int8")
        got = quant.llm_int8_linear(torch.as_tensor(x, device="cuda"), q,
                                    torch.as_tensor(bias, device="cuda"), sc)
        want = quant.llm_int8_linear(torch.as_tensor(x), qc,
                                     torch.as_tensor(bias), sc_c)
        exact = (torch.equal(q.cpu(), qc) and torch.equal(sc.cpu(), sc_c)
                 and torch.equal(got.cpu(), want))
        log(f"llm_int8_linear m{m} k{k} n{n}, {outliers} outlier column(s): "
            f"card == CPU bit for bit: {exact}, max|diff| "
            f"{(got.cpu() - want).abs().max().item():.3e}")
        if not exact:
            sys.exit(f"chip_smoke: llm_int8_linear on the card differs from "
                     f"the CPU at m{m} k{k} n{n}")


def phase_decode():
    """bench.py's decode legs through bench_decode.run_one: bench.py's six
    keys, peak memory per leg and K1 launches per call (one per layer
    where the router picks K1 at the prefill shape); the int8 snapshot
    must be DECODE_INT8_WEIGHT_MB, and the int8 greedy stream must equal
    generate's on a fresh build of the model whose matmul weights are the
    generator's own dequantized bf16 tensors. Then llm_int8_linear on the
    card against the CPU. Returns K1's launches over the decode path."""
    gc.collect()
    torch.cuda.empty_cache()
    c = DECODE_PREFILL
    dec = ar.route(c["b"] * c["h"], c["sq"], c["sk"], c["d"],
                   torch.bfloat16, c["causal"])
    log(f"router decode prefill (bh {c['b'] * c['h']}, s{c['sq']}, "
        f"d{c['d']}, bf16, causal): {dec}")
    zero_flash_launches()                      # the decode path starts here
    r = bench_decode.run_one("cuda")
    launches = fa.flash_fwd_launches           # the decode path ends here
    cfg, batch, prompt, new = bench_decode.bench_config("cuda")
    want = cfg.num_hidden_layers if dec.fwd == "pallas" else 0
    keys = ("decode_prefill_ms", "decode_per_token_ms",
            "decode_tokens_per_s", "decode_int8_per_token_ms",
            "decode_int8_tokens_per_s", "decode_int8_weight_mb")
    log(f"decode ({CARD}): " + json.dumps({k: r[k] for k in keys}))
    log(f"decode ({CARD}): seconds {json.dumps(r['seconds'])}, K1 launches "
        f"per call {json.dumps(r['k1_launches_per_call'])}, peak memory "
        f"bf16 leg {r['peak_memory_bytes']['bf16'] / 2**30:.3f} GiB, int8 "
        f"leg {r['peak_memory_bytes']['int8'] / 2**30:.3f} GiB, weights "
        f"{r['weight_bytes']} B bf16 against {r['quantized_bytes']} B int8")
    if any(v != want for v in r["k1_launches_per_call"].values()):
        sys.exit(f"chip_smoke: K1 launches per decode call "
                 f"{r['k1_launches_per_call']}, expected {want}")
    if r["decode_int8_weight_mb"] != DECODE_INT8_WEIGHT_MB:
        sys.exit(f"chip_smoke: decode_int8_weight_mb "
                 f"{r['decode_int8_weight_mb']} != {DECODE_INT8_WEIGHT_MB}")
    for name in ("ids", "int8_ids"):
        ids = r[name]
        if ids.shape != (batch, prompt + new) or ids.min().item() < 0 or \
                ids.max().item() >= cfg.vocab_size:
            sys.exit(f"chip_smoke: decode {name} of a wrong shape or out of "
                     f"the vocabulary")
    model, ids, _ = bench_decode.build("cuda")
    wog = generation.WeightOnlyGenerator(model, max_new_tokens=new)
    layers, head = wog.dequantized_weights()
    with torch.no_grad():
        for layer, lp in zip(model.llama.layers, layers):
            for k, p in layer.named_parameters():
                p.copy_(lp[k])
        model.lm_head.weight.copy_(head)
    same = torch.equal(generation.generate(model, ids, max_new_tokens=new),
                       r["int8_ids"])
    again = torch.equal(wog.generate(ids), r["int8_ids"])
    agree = (r["int8_ids"][:, prompt:] == r["ids"][:, prompt:]).float()
    log(f"decode: int8 stream == generate on the dequantized weights bit "
        f"for bit: {same}; == a fresh snapshot's: {again}; int8 tokens equal "
        f"to bf16's: {agree.mean().item():.2%} (information only)")
    if not (same and again):
        sys.exit("chip_smoke: the int8 stream is not generate's on the "
                 "dequantized weights")
    del model, wog, layers, head
    llm_int8_on_card()
    return launches


def flowers_transform():
    """Resize to 224 x 224, to CHW float32 in [0, 1], ImageNet's
    normalization: the port's vision.transforms as a user writes them."""
    return VT.Compose([VT.Resize((224, 224)), VT.ToTensor(),
                       VT.Normalize(mean=HAPI_MEAN, std=HAPI_STD)])


def hapi_resnet_model(device):
    """resnet50 with 102 classes in float32 through Model.prepare with
    Paddle's ResNet recipe under O1 AMP."""
    m = pt.Model(VM.resnet50(num_classes=102, device=device))
    m.prepare(optimizer.Momentum(
        learning_rate=optimizer.lr.PiecewiseDecay([4], [0.1, 0.01]),
        momentum=0.9, weight_decay=pt.L2Decay(1e-4),
        parameters=m.parameters()),
        pt.nn.CrossEntropyLoss(), metric.Accuracy(topk=(1, 5)),
        amp_configs="O1")
    return m


class BatchClock(callbacks.Callback):
    """Each batch's end time (host clock, after the loss's read-back), its
    loss, and the steps the GradScaler skipped."""

    def __init__(self):
        self.times, self.losses, self.skipped = [], [], 0

    def on_train_batch_end(self, step, logs=None):
        self.times.append(time.perf_counter())
        self.losses.append(logs["loss"])
        scaler = getattr(self.model, "_scaler", None)
        self.skipped += bool(scaler is not None and scaler._found_inf)


def cast_table(net, x, y):
    """(op name, input dtypes after the cast) of every op amp hooks in one
    eval-mode forward and cross-entropy under O1 (integers as "int")."""
    table = []
    amp._op_observer = lambda name, ts: table.append((name, tuple(
        "int" if not t.is_floating_point() else str(t.dtype)[6:]
        for t in ts)))
    modes = [(mod, mod.training) for mod in net.modules()]
    net.eval()
    try:
        with torch.no_grad(), amp.auto_cast(level="O1"):
            pt.nn.functional.cross_entropy(net(x), y)
    finally:
        amp._op_observer = None
        for mod, was in modes:
            mod.training = was
    return table


def loader_images_per_s(dataset):
    """Images/s of the fit's loader alone (shuffled, HAPI_WORKERS threads)
    over HAPI_ITERS - 1 batches after the first."""
    np.random.seed(1)
    loader = pio.DataLoader(dataset, batch_size=HAPI_BATCH, shuffle=True,
                            num_workers=HAPI_WORKERS)
    t0 = None
    for i, (x, _) in enumerate(loader):
        if i == 0:
            t0 = time.perf_counter()
        if i == HAPI_ITERS - 1:
            break
    return (HAPI_ITERS - 1) * HAPI_BATCH / (time.perf_counter() - t0)


def ms_beside_loader(dataset, fn, n=5):
    """fn()'s mean ms over n calls (each ending in a host sync) while a
    shuffled DataLoader of `dataset` (HAPI_WORKERS threads) is iterated
    in a thread beside them: what the loader's threads cost the thread
    that launches the step."""
    import threading
    stop = threading.Event()

    def drain():
        loader = pio.DataLoader(dataset, batch_size=HAPI_BATCH, shuffle=True,
                                num_workers=HAPI_WORKERS)
        for _ in loader:
            if stop.is_set():
                break

    t = threading.Thread(target=drain)
    t.start()
    try:
        time.sleep(0.5)             # the workers are fetching
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3
    finally:
        stop.set()
        t.join()


def same_state(a, b):
    """Whether two (optimizer or network) state dicts are equal, tensors
    bit for bit."""
    if a.keys() != b.keys():
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, torch.Tensor):
            if not (v.dtype == w.dtype and torch.equal(v.cpu(), w.cpu())):
                return False
        elif v != w:
            return False
    return True


def phase_hapi_resnet():
    """(a) ResNet-50 on Flowers-102 through Model.fit with O1 AMP; returns
    the flash kernels' launches over the fit (none is on this path)."""
    gc.collect()
    torch.cuda.empty_cache()
    tf = flowers_transform()
    train = VD.Flowers(mode="train", transform=tf)
    valid = VD.Flowers(mode="valid", transform=tf)
    pt.seed(0)
    m = hapi_resnet_model("cuda")
    init = {k: v.detach().cpu().clone()
            for k, v in m.network.state_dict().items()}
    cpu_net = VM.resnet50(num_classes=102, device="cpu")
    cpu_net.load_state_dict(init)
    x2, y2 = pio.default_collate_fn([train[i] for i in range(2)])
    card_table = cast_table(m.network, x2.cuda(), y2.cuda())
    cpu_table = cast_table(cpu_net, x2, y2)
    loader_ips = loader_images_per_s(train)

    first = {}
    fit_batch = m.train_batch

    def capture(inputs, labels=None, update=True):
        if not first:
            first["x"], first["y"] = inputs.clone(), labels.clone()
        return fit_batch(inputs, labels, update)

    m.train_batch = capture
    clock = BatchClock()
    ckpt = tempfile.mkdtemp(prefix="chip_smoke_hapi_")
    try:
        zero_flash_launches()                  # the hapi path starts here
        torch.cuda.reset_peak_memory_stats()
        np.random.seed(0)
        t0 = time.perf_counter()
        m.fit(train, eval_data=valid, batch_size=HAPI_BATCH,
              num_iters=HAPI_ITERS, num_workers=HAPI_WORKERS, verbose=0,
              callbacks=[callbacks.LRScheduler(),
                         callbacks.ModelCheckpoint(save_dir=ckpt), clock])
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
        launches = train_llama.launch_counts()  # the hapi path ends here
        k2 = fa.flash_fwd_rms_epilogue_launches
        peak = torch.cuda.max_memory_allocated()
        del m.train_batch
        ev1 = m.evaluate(valid, batch_size=HAPI_BATCH,
                         num_workers=HAPI_WORKERS, verbose=0)
        m2 = hapi_resnet_model("cuda")
        m2.load(os.path.join(ckpt, "final"))
        params_equal = same_state(m.network.state_dict(),
                                  m2.network.state_dict())
        opt_equal = same_state(m._optimizer.state_dict(),
                               m2._optimizer.state_dict())
        ev2 = m2.evaluate(valid, batch_size=HAPI_BATCH,
                          num_workers=HAPI_WORKERS, verbose=0)
        del m2
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    x, y = first["x"].cuda(), first["y"].cuda()
    for _ in range(2):
        m.train_batch(x, y)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        m.train_batch(x, y)
    torch.cuda.synchronize()
    batch_ms = (time.perf_counter() - t0) / 5 * 1e3
    beside_ms = ms_beside_loader(train, lambda: m.train_batch(x, y))
    by_class = kernel_ms_by_class(lambda: m.train_batch(x, y), resnet_class)
    scale, skipped = m._scaler._scale, clock.skipped
    del m
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cpu_net.train()
    with torch.no_grad(), amp.auto_cast(level="O1"):
        cpu_loss = float(pt.nn.functional.cross_entropy(cpu_net(first["x"]),
                                                        first["y"]))
    cpu_s = time.perf_counter() - t0
    loss_err = abs(clock.losses[0] - cpu_loss) / abs(cpu_loss)
    timed = clock.times[-1] - clock.times[0]
    ips = (len(clock.times) - 1) * HAPI_BATCH / timed
    log(f"hapi resnet50 O1 [{CARD}]: fit of {HAPI_ITERS} iterations at "
        f"b{HAPI_BATCH} 224x224 ({HAPI_WORKERS} loader threads) and the "
        f"evaluate of {len(valid)} images in {fit_s:.2f} s; "
        f"{ips:.1f} images/s over the {len(clock.times) - 1} timed "
        f"iterations, loader included ({timed / (len(clock.times) - 1) * 1e3:.2f} "
        f"ms an iteration); the loader alone {loader_ips:.1f} images/s; "
        f"train_batch with the batch on the card {batch_ms:.2f} ms "
        f"({HAPI_BATCH / batch_ms * 1e3:.1f} images/s), {beside_ms:.2f} ms "
        f"with the loader's threads running beside it ({os.cpu_count()} "
        f"host CPUs); peak memory {peak / 2**30:.2f} GiB")
    log(f"hapi resnet50 O1, one traced train_batch: {class_line(by_class)}; "
        f"busy {sum(by_class.values()) / batch_ms:.1%} of train_batch")
    log(f"hapi resnet50 O1: losses {clock.losses}; GradScaler scale "
        f"{scale:g}, {skipped} steps skipped; evaluate top-1 "
        f"{ev1['acc_top1']:.4f} top-5 {ev1['acc_top5']:.4f} loss "
        f"{ev1['loss'][0]:.6f}; after Model.load into a fresh Model: "
        f"parameters equal {params_equal}, optimizer state equal "
        f"{opt_equal}, evaluate {ev2}")
    log(f"hapi resnet50 O1: cast table of {len(card_table)} ops equal to "
        f"the CPU's {card_table == cpu_table} ("
        + ", ".join(f"{n} x{c}: {d}" for (n, d), c in sorted(
            {(n, d): sum(1 for e in card_table if e == (n, d))
             for n, d in card_table}.items())) + f"); first loss "
        f"{clock.losses[0]:.6f} vs the CPU's {cpu_loss:.6f} (rel err "
        f"{loss_err:.3e}, tol {RESNET_BF16_LOSS_RTOL}; CPU forward "
        f"{cpu_s:.1f} s); launches over the fit {launches}, K2 {k2}")
    want_ops = {("conv2d", ("bfloat16",) * 2): 53,
                ("batch_norm", ("float32",) * 5): 53,
                ("linear", ("bfloat16",) * 3): 1,
                ("cross_entropy", ("float32", "int")): 1}
    counts = {}
    for e in card_table:
        counts[e] = counts.get(e, 0) + 1
    if card_table != cpu_table or counts != want_ops:
        sys.exit("chip_smoke: the O1 cast table on the card differs from "
                 "the CPU's or from the reference's lists")
    if not all(np.isfinite(clock.losses)) or len(clock.losses) != \
            HAPI_ITERS:
        sys.exit("chip_smoke: Model.fit's losses are not finite or not "
                 f"{HAPI_ITERS}")
    if not loss_err <= RESNET_BF16_LOSS_RTOL:
        sys.exit("chip_smoke: the first O1 loss on the card disagrees with "
                 "the CPU's")
    if not (params_equal and opt_equal and ev1 == ev2):
        sys.exit("chip_smoke: the checkpoint did not round-trip")
    if k2 or any(launches.values()):
        sys.exit("chip_smoke: the hapi ResNet run launched a flash kernel")
    return launches


def phase_hapi_bert(decision, phase14_ms):
    """(b) BERT-base (bench.py's configuration) with PaddleNLP's optimizer
    through train_bert.run_one(optimizer_name="paddlenlp"); returns each
    kernel's launches over the run. First one step's clip global norm
    against a float64 recomputation of the same gradients."""
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq, _, dtype = train_bert.bench_config("cuda")
    n_layers = cfg.num_hidden_layers
    train = train_bert.TrainStep(cfg, batch, seq, dtype, "cuda",
                                 "paddlenlp", HAPI_BERT_STEPS + 1)
    train.model(train.ids, masked_lm_labels=train.labels)[0].float() \
        .backward()
    grads = [p.grad for p in train.model.parameters() if p.grad is not None]
    norm = float(pt.nn.ClipGradByGlobalNorm.global_norm(grads))
    norm64 = float(torch.stack([g.double().square().sum()
                                for g in grads]).sum().sqrt())
    del train, grads
    gc.collect()
    torch.cuda.empty_cache()
    norm_err = abs(norm - norm64) / norm64
    zero_flash_launches()                      # the path starts here
    r = train_bert.run_one(cfg, batch, seq, HAPI_BERT_STEPS, dtype,
                           device="cuda", optimizer_name="paddlenlp")
    launches = train_llama.launch_counts()     # the path ends here
    log(f"hapi bert_base PaddleNLP AdamW [{CARD}]: LinearWarmup into "
        f"PolynomialDecay, decay but on biases and norms, "
        f"ClipGradByGlobalNorm(1.0); b{batch} s{seq} {dtype}; step "
        f"{r['step_ms']:.2f} ms against phase 14's {phase14_ms:.2f} ms "
        f"({r['step_ms'] - phase14_ms:+.2f} ms), peak memory "
        f"{r['peak_memory_bytes'] / 2**30:.2f} GiB; losses {r['losses']}; "
        f"global norm {norm:.6f} vs float64 {norm64:.6f} (rel err "
        f"{norm_err:.3e}, tol {HAPI_CLIP_NORM_RTOL}); launches {launches}")
    fwd = decision.fwd == "pallas"
    bwd = fwd and decision.bwd == "pallas"
    want = {"flash_fwd": n_layers if fwd else 0,
            "flash_bwd_dq": n_layers if bwd else 0,
            "flash_bwd_dkv": n_layers if bwd else 0}
    if not all(np.isfinite(r["losses"])) or not \
            r["losses"][-1] < r["losses"][0]:
        sys.exit("chip_smoke: the PaddleNLP-recipe BERT losses are not "
                 "finite or did not fall")
    if any(per_step != want for per_step in r["launches_per_step"]):
        sys.exit(f"chip_smoke: a PaddleNLP-recipe BERT step launched "
                 f"{r['launches_per_step']}, expected {want} each")
    if not norm_err <= HAPI_CLIP_NORM_RTOL:
        sys.exit("chip_smoke: the clip's global norm disagrees with float64")
    return launches


def lenet_mnist(device, init):
    """examples/train_lenet_mnist.py on the port: LeNet (weights `init`),
    Adam(1e-3), CrossEntropyLoss, Accuracy; one epoch of MNIST("train")
    at b64 in a shuffle from np.random.seed(0), then evaluate on
    MNIST("test") at b128. Returns (losses, evaluate's result, seconds)."""
    net = VM.LeNet(device=device)
    net.load_state_dict(init)
    m = pt.Model(net)
    m.prepare(optimizer.Adam(1e-3, parameters=m.parameters()),
              pt.nn.CrossEntropyLoss(), metric.Accuracy())
    clock = BatchClock()
    np.random.seed(0)
    t0 = time.perf_counter()
    m.fit(VD.MNIST(mode="train"), epochs=1, batch_size=64, verbose=0,
          callbacks=[clock])
    res = m.evaluate(VD.MNIST(mode="test"), batch_size=128, verbose=0)
    return clock.losses, res, time.perf_counter() - t0


def phase_hapi_lenet():
    """(c) The ladder's first rung on the card against the CPU port's run
    of the same weights; returns the flash kernels' launches (none)."""
    pt.seed(0)
    init = VM.LeNet(device="cpu").state_dict()
    zero_flash_launches()
    losses, res, secs = lenet_mnist("cuda", init)
    launches = train_llama.launch_counts()
    cpu_losses, cpu_res, cpu_secs = lenet_mnist("cpu", init)
    acc_err = abs(res["acc"] - cpu_res["acc"])
    log(f"hapi lenet MNIST [{CARD}]: {len(losses)} batches of 64, loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; test loss "
        f"{res['loss'][0]:.4f} acc {res['acc']:.4f} ({secs:.2f} s); the "
        f"CPU's: loss {cpu_losses[0]:.4f} -> {cpu_losses[-1]:.4f}, test "
        f"loss {cpu_res['loss'][0]:.4f} acc {cpu_res['acc']:.4f} "
        f"({cpu_secs:.2f} s); acc diff {acc_err:.4f} (tol "
        f"{HAPI_LENET_ACC_ATOL})")
    if len(losses) != 32 or not all(np.isfinite(losses)) or not \
            losses[-1] < losses[0]:
        sys.exit("chip_smoke: LeNet's epoch did not train")
    if not acc_err <= HAPI_LENET_ACC_ATOL:
        sys.exit("chip_smoke: LeNet's accuracy on the card disagrees with "
                 "the CPU's")
    if any(launches.values()):
        sys.exit("chip_smoke: the LeNet run launched a flash kernel")
    return launches


def phase_hapi(decision, phase14_ms):
    """Phase 19: the high-level API on the card; each path's flash kernel
    launches summed."""
    t0 = time.perf_counter()
    runs = (phase_hapi_resnet(), phase_hapi_bert(decision, phase14_ms),
            phase_hapi_lenet())
    log(f"phase 19 (hapi) took {time.perf_counter() - t0:.1f} s")
    return {k: sum(r[k] for r in runs) for k in runs[0]}


# ---------------------------------------------------------------------------
# phase 20: machine translation. The models are written as a user of the
# package writes them, against the package `P` they are given: the port
# here, and the JAX package too in tests/test_torch_seq_slice.py, which
# holds the same code at a small size to the reference.
# ---------------------------------------------------------------------------

def sinusoid_table(length, d_model):
    """Vaswani et al.'s positions: sin on even features, cos on odd ones,
    of pos / 10000^(2i / d_model); float32 (length, d_model)."""
    pos = np.arange(length)[:, None]
    i = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10000.0, i / d_model)
    table = np.zeros((length, d_model), np.float32)
    table[:, 0::2] = np.sin(angle)
    table[:, 1::2] = np.cos(angle)
    return table


def transformer_mt(P, vocab, d_model, nhead, layers, ff, dropout, max_len):
    """Transformer for translation on one shared vocabulary: the source
    and target embeddings and the pre-softmax projection share one
    matrix (Vaswani et al. 2017, §3.4), embeddings times sqrt(d_model) plus
    sinusoidal positions, residual dropout `dropout` and none on the
    attention weights or the ReLU (tensor2tensor's transformer_base_v1)."""

    class TransformerMT(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.d_model = d_model
            self.embed = P.nn.Embedding(
                vocab, d_model, weight_attr=P.ParamAttr(
                    initializer=P.nn.initializer.Normal(0.0, d_model ** -0.5)))
            self.transformer = P.nn.Transformer(
                d_model, nhead, layers, layers, ff, dropout,
                attn_dropout=0.0, act_dropout=0.0)
            self.dropout = P.nn.Dropout(dropout)
            self.register_buffer("pos", P.to_tensor(
                sinusoid_table(max_len, d_model)), persistable=False)

        def embed_tokens(self, ids):
            x = self.embed(ids) * (self.d_model ** 0.5)
            return self.dropout(x + self.pos[:ids.shape[1]])

        def forward(self, src, tgt):
            mask = self.transformer.generate_square_subsequent_mask(
                tgt.shape[1])
            h = self.transformer(self.embed_tokens(src),
                                 self.embed_tokens(tgt), tgt_mask=mask)
            return P.matmul(h, self.embed.weight, transpose_y=True)

    return TransformerMT()


def transformer_loss(P, model, src, tgt_in, labels):
    logits = model(src, tgt_in)
    return P.nn.functional.cross_entropy(
        P.reshape(logits, [-1, logits.shape[-1]]), P.reshape(labels, [-1]),
        label_smoothing=MT_LABEL_SMOOTHING)


def lstm_seq2seq(P, src_vocab, tgt_vocab, hidden, dropout):
    """tensorflow/nmt's attention model (standard_hparams/iwslt15.json):
    a bidirectional LSTM encoder ("bi" with 2 layers: one layer each way),
    a decoder of two LSTMCells fed the previous attention vector (input
    feeding), Luong attention scored by dot product against the encoder
    outputs' projection, a = tanh(W [h; context]), and the projection to
    the target vocabulary. Embeddings and projections Uniform(-0.1, 0.1),
    nmt's init_weight."""
    init = P.ParamAttr(initializer=P.nn.initializer.Uniform(-0.1, 0.1))

    class AttentionCell(P.nn.RNNCellBase):
        """One decoder step; `memory` and `keys` (the encoder's outputs and
        their projection) are set before a batch is decoded."""

        def __init__(self):
            super().__init__()
            self.hidden_size = hidden
            self.cell1 = P.nn.LSTMCell(2 * hidden, hidden)
            self.cell2 = P.nn.LSTMCell(hidden, hidden)
            self.attn_out = P.nn.Linear(3 * hidden, hidden, init, False)
            self.dropout = P.nn.Dropout(dropout)
            self.memory = self.keys = None

        def forward(self, inputs, states):
            s1, s2, attn = states
            x = P.concat([inputs, attn], axis=-1)
            h1, s1 = self.cell1(self.dropout(x), s1)
            h2, s2 = self.cell2(self.dropout(h1), s2)
            scores = P.matmul(self.keys, P.unsqueeze(h2, -1))   # (B, T, 1)
            probs = P.nn.functional.softmax(scores, axis=1)
            ctx = P.squeeze(P.matmul(probs, self.memory, transpose_x=True),
                            1)
            attn = P.nn.functional.tanh(self.attn_out(
                P.concat([h2, ctx], axis=-1)))
            return attn, (s1, s2, attn)

    class Seq2Seq(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.src_embed = P.nn.Embedding(src_vocab, hidden,
                                            weight_attr=init)
            self.encoder = P.nn.LSTM(hidden, hidden, direction="bidirect")
            self.mem_proj = P.nn.Linear(2 * hidden, hidden, init, False)
            self.tgt_embed = P.nn.Embedding(tgt_vocab, hidden,
                                            weight_attr=init)
            self.decoder = P.nn.RNN(AttentionCell())
            self.project = P.nn.Linear(hidden, tgt_vocab, init, False)
            self.dropout = P.nn.Dropout(dropout)

        def encode(self, src):
            """The encoder's outputs, their projection, and the decoder's
            first states: each direction's last state into one cell, and
            a zero attention vector."""
            out, (h, c) = self.encoder(self.dropout(self.src_embed(src)))
            return out, self.mem_proj(out), ((h[0], c[0]), (h[1], c[1]),
                                             P.zeros_like(h[0]))

        def forward(self, src, tgt_in):
            memory, keys, states = self.encode(src)
            cell = self.decoder.cell
            cell.memory, cell.keys = memory, keys
            out, _ = self.decoder(self.tgt_embed(tgt_in), states)
            return self.project(out)

    return Seq2Seq()


def seq2seq_loss(P, model, src, tgt_in, labels):
    logits = model(src, tgt_in)
    return P.nn.functional.cross_entropy(
        P.reshape(logits, [-1, logits.shape[-1]]), P.reshape(labels, [-1]))


def beam_decode(P, model, src, beam, max_steps, decoder_cls=None):
    """Beam search over `model`'s decoder cell for the sentences `src`,
    the encoder's outputs tiled beam times: (BeamSearchOutput, lengths)."""
    decoder_cls = decoder_cls or P.nn.BeamSearchDecoder
    memory, keys, states = model.encode(src)
    cell = model.decoder.cell
    cell.memory = decoder_cls.tile_beam_merge_with_batch(memory, beam)
    cell.keys = decoder_cls.tile_beam_merge_with_batch(keys, beam)
    dec = decoder_cls(cell, MT_BOS, MT_EOS, beam,
                      embedding_fn=model.tgt_embed, output_fn=model.project)
    out, _, lengths = P.nn.dynamic_decode(dec, inits=states,
                                          max_step_num=max_steps)
    return out, lengths


def mt_tokens(seed, batch, length, vocab):
    """Token ids in [3, vocab) from RandomState(seed): 0-2 are kept for
    padding, BOS and EOS, and no batch has padding."""
    return np.random.RandomState(seed).randint(3, vocab, (batch, length))


class RecordingBeamSearch(pt.nn.BeamSearchDecoder):
    """The port's BeamSearchDecoder, keeping each step's (token, parent,
    top scores) so two decodes can be compared step by step."""

    steps = None

    def step(self, ids, states, log_probs, finished):
        out = super().step(ids, states, log_probs, finished)
        self.steps.append(tuple(t.detach().cpu() for t in
                                (out[4], out[5], out[2])))
        return out

    @classmethod
    def run(cls, model, src, beam, max_steps):
        cls.steps = []
        out, lengths = beam_decode(pt, model, src, beam, max_steps, cls)
        return out, lengths, cls.steps


class ReplayBeamSearch(pt.nn.BeamSearchDecoder):
    """The port's BeamSearchDecoder forced along a recorded decode: at each
    step the recorded tokens, parents and top scores replace its own
    choice, so the next step starts from the recorded running scores.
    Keeps each step's largest |recorded top score - own total of the same
    extension| (`score_gaps`) and, where its own top-k picks other
    extensions, the largest gap between its own sorted totals of the
    recorded ones and its own top-k totals (`tie_gaps`, 0 where it agrees)."""

    record = score_gaps = tie_gaps = None

    def step(self, ids, states, log_probs, finished):
        token, parent, top = (t.to(log_probs.device)
                              for t in self.record[len(self.score_gaps)])
        total, next_states = self.candidates(ids, states, log_probs,
                                             finished)
        vocab = total.shape[-1] // self.beam_size
        idx = parent * vocab + token
        own = total.gather(1, idx)
        self.score_gaps.append(float((top - own).abs().max()))
        own_top, own_idx = torch.topk(total, self.beam_size)
        tie = (0.0 if torch.equal(own_idx, idx) else float(
            (own.sort(1, descending=True).values - own_top).abs().max()))
        self.tie_gaps.append(tie)
        return self.select(top, idx, next_states, finished, vocab)

    @classmethod
    def run(cls, model, src, record, beam, max_steps):
        cls.record, cls.score_gaps, cls.tie_gaps = record, [], []
        out, lengths = beam_decode(pt, model, src, beam, max_steps, cls)
        return out, lengths, cls.score_gaps, cls.tie_gaps


def first_divergence(card_steps, cpu_steps):
    """None if the two decodes chose the same (token, parent) at every
    step; else (step, the largest |score gap| of the beams' totals there,
    the largest |score| there)."""
    for t, (a, b) in enumerate(zip(card_steps, cpu_steps)):
        if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
            return t, float((a[2] - b[2]).abs().max()), \
                float(b[2].abs().max())
    if len(card_steps) != len(cpu_steps):
        return min(len(card_steps), len(cpu_steps)), float("inf"), 1.0
    return None


def transformer_flops(n_params_enc, n_params_dec, n_proj, batch, seq,
                      layers, d_model):
    """Training FLOPs of a step: 6 x (matrix-product weights x the tokens
    that pass them) + 12 x b x s^2 x d per attention (QK^T and PV, forward
    and backward), of which each encoder layer has one and each decoder
    layer two."""
    tokens = batch * seq
    dense = 6 * tokens * (n_params_enc + n_params_dec + n_proj)
    attn = 12 * batch * seq * seq * d_model * 3 * layers
    return dense + attn


def matmul_params(layer):
    """Weights of the layer's Linear products (biases and norms left out)."""
    return sum(m.weight.numel() for m in layer.sublayers()
               if isinstance(m, pt.nn.Linear))


def timed_steps(step, n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step() for _ in range(n)]
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / n * 1e3, [float(x) for x in losses]


def phase_mt_transformer():
    """(a) Transformer-base training; returns K1/K3/K4 launches over the
    timed steps."""
    gc.collect()
    torch.cuda.empty_cache()
    pt.seed(0)
    model = transformer_mt(pt, MT_VOCAB, 512, 8, 6, 2048, MT_DROPOUT,
                           MT_SEQ + 1).to(torch.bfloat16)
    sched = optimizer.lr.NoamDecay(512, MT_WARMUP)
    opt = optimizer.Adam(learning_rate=sched, beta1=0.9, beta2=0.98,
                         epsilon=1e-9, parameters=model.parameters())
    src = torch.tensor(mt_tokens(1, MT_BATCH, MT_SEQ, MT_VOCAB),
                       device="cuda")
    tgt = torch.tensor(mt_tokens(2, MT_BATCH, MT_SEQ + 1, MT_VOCAB),
                       device="cuda")
    tgt_in, labels = tgt[:, :-1], tgt[:, 1:]

    def step():
        loss = transformer_loss(pt, model, src, tgt_in, labels)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.detach()

    route = ar.route(MT_BATCH * 8, MT_SEQ, MT_SEQ, 64, torch.bfloat16,
                     False, platform="cuda")
    first = float(step())                     # warm-up
    zero_flash_launches()                     # the path starts here
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = timed_steps(step, MT_STEPS)
    launches = train_llama.launch_counts()    # the path ends here
    peak = torch.cuda.max_memory_allocated()
    by_class = kernel_ms_by_class(step)
    enc_p = matmul_params(model.transformer.encoder)
    dec_p = matmul_params(model.transformer.decoder)
    proj_p = model.embed.weight.numel()
    flops = transformer_flops(enc_p, dec_p, proj_p, MT_BATCH, MT_SEQ, 6, 512)
    n_params = sum(p.numel() for p in model.parameters())
    tokens_s = 2 * MT_BATCH * MT_SEQ / step_ms * 1e3
    mfu = flops / (step_ms / 1e3) / BF16_FLOP_PER_S
    per_step = {k: v // MT_STEPS for k, v in launches.items()}
    mm_params = enc_p + dec_p + proj_p
    log(f"mt transformer-base [{CARD}]: {n_params} params ({mm_params} in "
        f"matrix products, the tied projection once), vocab "
        f"{MT_VOCAB}, b{MT_BATCH} x {MT_SEQ} source and target tokens, bf16, "
        f"Adam(0.9, 0.98, 1e-9) under NoamDecay(512, {MT_WARMUP}); step "
        f"{step_ms:.2f} ms ({MT_STEPS} timed after 1), {tokens_s:.1f} "
        f"tokens/s (source + target), MFU {mfu:.4f} = {flops / 1e12:.4f} "
        f"TFLOP a step [6 x weights x tokens + 12 b s^2 d per attention] "
        f"/ step s / {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"mt transformer-base: router at the encoder self-attention "
        f"(bh={MT_BATCH * 8}, s={MT_SEQ}, d64, not causal): fwd={route.fwd} "
        f"bwd={route.bwd} source={route.source}; the cross-attention "
        f"(queries and keys {MT_SEQ}, the same key): fwd={route.fwd} "
        f"bwd={route.bwd}; the decoder's self-attention carries the "
        f"additive causal tgt_mask: dense, never routed; launches per step "
        f"{per_step}")
    log(f"mt transformer-base, one traced step: {class_line(by_class)}; "
        f"busy {sum(by_class.values()) / step_ms:.1%} of the timed steps' "
        f"mean")
    log(f"mt transformer-base: losses {[first] + losses}")
    fwd = route.fwd == "pallas"
    bwd = fwd and route.bwd == "pallas"
    want = {"flash_fwd": 12 if fwd else 0,
            "flash_bwd_dq": 12 if bwd else 0,
            "flash_bwd_dkv": 12 if bwd else 0}
    if not all(np.isfinite([first] + losses)):
        sys.exit("chip_smoke: a Transformer-base loss is not finite")
    if per_step != want or any(v % MT_STEPS for v in launches.values()):
        sys.exit(f"chip_smoke: Transformer-base launched {launches} over "
                 f"{MT_STEPS} steps, expected {want} a step")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches, step_ms


def phase_mt_twin():
    """(a)'s float32 twin at 2 + 2 layers and full widths, dropout off: the
    first loss and the gradient norm on the card against the CPU's, the
    same weights and batch."""
    pt.seed(0)
    model = transformer_mt(pt, MT_VOCAB, 512, 8, 2, 2048, 0.0, MT_SEQ + 1)
    src = torch.tensor(mt_tokens(1, MT_BATCH, MT_SEQ, MT_VOCAB))
    tgt = torch.tensor(mt_tokens(2, MT_BATCH, MT_SEQ + 1, MT_VOCAB))
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        loss = transformer_loss(pt, m, src.to(dev), tgt[:, :-1].to(dev),
                                tgt[:, 1:].to(dev))
        loss.backward()
        norm = float(torch.sqrt(sum(p.grad.double().square().sum()
                                    for p in m.parameters())))
        out[dev] = (float(loss.detach()), norm)
        m.clear_gradients()
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    norm_err = abs(out["cuda"][1] - out["cpu"][1]) / out["cpu"][1]
    log(f"mt transformer twin (float32, 2 + 2 layers, d512, dropout off, "
        f"TF32 off): loss card {out['cuda'][0]:.7f} CPU {out['cpu'][0]:.7f} "
        f"(rel err {loss_err:.3e}, tol {MT_TWIN_LOSS_RTOL}); grad norm card "
        f"{out['cuda'][1]:.7f} CPU {out['cpu'][1]:.7f} (rel err "
        f"{norm_err:.3e}, tol {MT_TWIN_GRAD_RTOL})")
    if not (loss_err <= MT_TWIN_LOSS_RTOL and norm_err <= MT_TWIN_GRAD_RTOL):
        sys.exit("chip_smoke: the Transformer twin on the card disagrees "
                 "with the CPU")


def phase_mt_lstm():
    """(b) LSTM seq2seq: training through nn.RNN, then beam search; returns
    the flash kernels' launches over both (none is on this path)."""
    gc.collect()
    torch.cuda.empty_cache()
    pt.seed(0)
    model = lstm_seq2seq(pt, NMT_SRC_VOCAB, NMT_TGT_VOCAB, NMT_HIDDEN,
                         NMT_DROPOUT).to("cuda")
    opt = optimizer.SGD(learning_rate=1.0, parameters=model.parameters(),
                        grad_clip=pt.nn.ClipGradByGlobalNorm(5.0))
    src = torch.tensor(mt_tokens(3, NMT_BATCH, NMT_LEN, NMT_SRC_VOCAB),
                       device="cuda")
    tgt = torch.tensor(mt_tokens(4, NMT_BATCH, NMT_LEN + 1, NMT_TGT_VOCAB),
                       device="cuda")

    def step():
        loss = seq2seq_loss(pt, model, src, tgt[:, :-1], tgt[:, 1:])
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    first = float(step())
    zero_flash_launches()                     # the path starts here
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = timed_steps(step, NMT_STEPS)
    train_peak = torch.cuda.max_memory_allocated()
    by_class = kernel_ms_by_class(step)
    model.eval()
    sents = src[:NMT_DECODE_BATCH]
    with torch.no_grad():
        beam_decode(pt, model, sents, NMT_BEAM, NMT_MAX_STEPS)   # warm-up
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, lengths, card_steps = RecordingBeamSearch.run(
            model, sents, NMT_BEAM, NMT_MAX_STEPS)
        torch.cuda.synchronize()
        decode_ms = (time.perf_counter() - t0) * 1e3
        dec_peak = torch.cuda.max_memory_allocated()
        dec_class = kernel_ms_by_class(lambda: beam_decode(
            pt, model, sents, NMT_BEAM, NMT_MAX_STEPS))
    launches = train_llama.launch_counts()    # the path ends here
    n_steps = len(card_steps)
    cpu_model = copy.deepcopy(model).to("cpu")
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_out, cpu_len, cpu_steps = RecordingBeamSearch.run(
            cpu_model, sents.cpu(), NMT_BEAM, NMT_MAX_STEPS)
    cpu_s = time.perf_counter() - t0
    same = torch.equal(out.predicted_ids.cpu(), cpu_out.predicted_ids)
    div = first_divergence(card_steps, cpu_steps)
    with torch.no_grad():
        re_out, re_len, score_gaps, tie_gaps = ReplayBeamSearch.run(
            cpu_model, sents.cpu(), card_steps, NMT_BEAM, NMT_MAX_STEPS)
    replayed = (len(score_gaps) == n_steps
                and torch.equal(re_out.predicted_ids, out.predicted_ids.cpu())
                and torch.equal(re_out.parent_ids, out.parent_ids.cpu())
                and torch.equal(re_len, lengths.cpu()))
    worst = int(np.argmax(score_gaps))
    ties = [t for t, g in enumerate(tie_gaps) if g > 0]
    max_score = float(card_steps[-1][2].abs().max())
    n_params = sum(p.numel() for p in model.parameters())
    train_tokens = NMT_BATCH * NMT_LEN * 2 / step_ms * 1e3
    decode_tokens = int(lengths.sum()) / decode_ms * 1e3
    log(f"mt lstm seq2seq [{CARD}]: {n_params} params, vocab "
        f"{NMT_SRC_VOCAB}/{NMT_TGT_VOCAB}, {NMT_HIDDEN} units, b{NMT_BATCH} "
        f"x {NMT_LEN}, float32, SGD(1.0) with ClipGradByGlobalNorm(5.0); "
        f"train step {step_ms:.2f} ms ({NMT_STEPS} timed after 1), "
        f"{train_tokens:.1f} tokens/s (source + target), peak memory "
        f"{train_peak / 2**30:.2f} GiB; losses {[first] + losses}")
    log(f"mt lstm seq2seq, one traced train step: {class_line(by_class)}; "
        f"busy {sum(by_class.values()) / step_ms:.1%} of the timed steps' "
        f"mean")
    log(f"mt lstm beam search [{CARD}]: {NMT_DECODE_BATCH} sentences, beam "
        f"{NMT_BEAM}, {n_steps} decode steps (max {NMT_MAX_STEPS}); "
        f"{decode_ms:.2f} ms, {decode_ms / n_steps:.3f} ms a decode step, "
        f"{decode_tokens:.1f} tokens/s over the beams' lengths "
        f"(sum {int(lengths.sum())}); peak memory {dec_peak / 2**30:.2f} GiB; "
        f"one traced decode: {class_line(dec_class)}; busy "
        f"{sum(dec_class.values()) / decode_ms:.1%}")
    gap = ("none" if div is None else
           f"step {div[0]}: score gap {div[1]:.3e} at |score| {div[2]:.1f}")
    log(f"mt lstm beam search: predicted_ids equal to the CPU's own decode "
        f"{same} (CPU decode {cpu_s:.1f} s); first differing step {gap}; "
        f"launches {launches}")
    log(f"mt lstm beam search, the CPU forced along the card's {n_steps} "
        f"steps: ids, parents and lengths equal {replayed}; largest score gap "
        f"{score_gaps[worst]:.3e} at step {worst} (tol {NMT_SCORE_ATOL}, "
        f"|score| up to {max_score:.1f}); the card picked other extensions "
        f"than the CPU's top-k at {len(ties)} steps {ties[:10]}, largest "
        f"tie gap {max(tie_gaps):.3e} (tol {NMT_TIE_ATOL})")
    if not all(np.isfinite([first] + losses)) or not losses[-1] < first:
        sys.exit("chip_smoke: the seq2seq losses are not finite or did not "
                 "fall")
    if tuple(out.predicted_ids.shape[::2]) != (NMT_DECODE_BATCH, NMT_BEAM):
        sys.exit("chip_smoke: beam search's predicted_ids have the wrong "
                 "shape")
    if not (replayed and max(score_gaps) <= NMT_SCORE_ATOL
            and max(tie_gaps) <= NMT_TIE_ATOL):
        sys.exit("chip_smoke: the CPU forced along the card's beams "
                 "disagrees with the card's scores or choices")
    if any(launches.values()):
        sys.exit("chip_smoke: the LSTM path launched a flash kernel")
    del model, cpu_model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_mt():
    """Phase 20: machine translation on the card; each path's flash kernel
    launches summed."""
    t0 = time.perf_counter()
    transformer, _ = phase_mt_transformer()
    phase_mt_twin()
    lstm = phase_mt_lstm()
    log(f"phase 20 (machine translation) took "
        f"{time.perf_counter() - t0:.1f} s")
    return {k: transformer[k] + lstm[k] for k in transformer}



# ---------------------------------------------------------------------------
# phase 21: a Vision Transformer and a diffusion U-Net, written as a user
# writes them against a package P (the port, or the JAX package in the
# tests: tests/test_torch_vision_slice.py)
# ---------------------------------------------------------------------------

def vit(P, image, patch, dim, depth, heads, mlp, classes, drop_path):
    """ViT (Dosovitskiy et al. 2021) as DeiT trains it (Touvron et al.
    2021): patches by a strided convolution, a class token and learned
    positions, pre-norm blocks (LayerNorm eps 1e-6) whose attention is one
    Linear(dim, 3 dim) reshaped to (b, s, 3, heads, dim / heads) into
    F.flash_attn_qkvpacked, a GELU MLP, stochastic depth rising linearly to
    `drop_path` over the blocks (nn.Identity where it is 0), and a linear
    head on the final norm of the class token."""
    F = P.nn.functional

    class DropPath(P.nn.Layer):
        """Each sample's residual branch dropped with probability p, the
        kept ones scaled by 1 / (1 - p)."""

        def __init__(self, p):
            super().__init__()
            self.p = p

        def forward(self, x):
            if not self.training:
                return x
            keep = 1.0 - self.p
            mask = P.floor(keep + P.rand([x.shape[0], 1, 1], dtype=x.dtype))
            return x / keep * mask

    class Block(P.nn.Layer):
        def __init__(self, dp):
            super().__init__()
            self.norm1 = P.nn.LayerNorm(dim, epsilon=1e-6)
            self.qkv = P.nn.Linear(dim, 3 * dim)
            self.proj = P.nn.Linear(dim, dim)
            self.norm2 = P.nn.LayerNorm(dim, epsilon=1e-6)
            self.fc1 = P.nn.Linear(dim, mlp)
            self.act = P.nn.GELU()
            self.fc2 = P.nn.Linear(mlp, dim)
            self.drop_path = DropPath(dp) if dp > 0 else P.nn.Identity()

        def forward(self, x):
            b, s = x.shape[0], x.shape[1]
            qkv = P.reshape(self.qkv(self.norm1(x)),
                            [b, s, 3, heads, dim // heads])
            a, _ = F.flash_attn_qkvpacked(qkv)
            x = x + self.drop_path(self.proj(P.reshape(a, [b, s, dim])))
            return x + self.drop_path(
                self.fc2(self.act(self.fc1(self.norm2(x)))))

    class ViT(P.nn.Layer):
        def __init__(self):
            super().__init__()
            tokens = (image // patch) ** 2 + 1
            init = P.nn.initializer.Normal(0.0, 0.02)
            self.patch_embed = P.nn.Conv2D(3, dim, patch, stride=patch)
            self.cls_token = self.create_parameter(
                [1, 1, dim], default_initializer=init)
            self.pos_embed = self.create_parameter(
                [1, tokens, dim], default_initializer=init)
            self.blocks = P.nn.LayerList(
                [Block(drop_path * i / max(depth - 1, 1))
                 for i in range(depth)])
            self.norm = P.nn.LayerNorm(dim, epsilon=1e-6)
            self.head = P.nn.Linear(dim, classes)

        def forward(self, images):
            x = self.patch_embed(images)
            x = P.transpose(P.flatten(x, 2), [0, 2, 1])
            cls = P.expand(self.cls_token, [x.shape[0], 1, dim])
            x = P.concat([cls, x], 1) + self.pos_embed
            for blk in self.blocks:
                x = blk(x)
            return self.head(self.norm(x)[:, 0])

    return ViT()


def vit_loss(P, model, images, labels, perm, lam, classes, smoothing):
    """DeiT's objective on a mixup batch: images lam x + (1 - lam) x[perm],
    targets the same mix of one-hot labels, smoothed by F.label_smooth,
    under a soft-label cross-entropy."""
    F = P.nn.functional
    mixed = lam * images + (1.0 - lam) * P.gather(images, perm)
    onehot = F.one_hot(labels, classes)
    target = lam * onehot + (1.0 - lam) * P.gather(onehot, perm)
    logits = model(mixed)
    return F.cross_entropy(P.cast(logits, "float32"),
                           F.label_smooth(target, epsilon=smoothing),
                           soft_label=True)


def vit_flops(model, batch, tokens, dim, depth):
    """Training FLOPs of a step: 3 x 2 x (each Linear's and the patch
    convolution's weights x the tokens that pass them + 2 s^2 d
    multiply-adds of QK^T and PV per block), per image, times the batch."""
    blocks = sum(p.weight.numel() for blk in model.blocks
                 for p in (blk.qkv, blk.proj, blk.fc1, blk.fc2))
    macs = (tokens * blocks + (tokens - 1) * model.patch_embed.weight.numel()
            + model.head.weight.numel() + depth * 2 * tokens ** 2 * dim)
    return 6 * macs * batch, macs


def ddpm_unet(P, ch, ch_mult, num_res, attn_res, dropout, image):
    """The DDPM noise predictor (Ho et al. 2020, App. B; diffusion_tf's
    models/unet.py): a sinusoidal time embedding through two Linear layers
    (4 ch, swish), residual blocks GroupNorm(32) -> swish -> 3x3 conv (+
    the projected time embedding) -> GroupNorm(32) -> swish -> dropout ->
    3x3 conv with a 1x1 shortcut where the width changes, one-head
    self-attention blocks at the `attn_res` resolutions, strided 3x3
    convolutions down and nearest x2 by F.interpolate then a 3x3
    convolution up, `num_res` blocks a level down and num_res + 1 up, and
    GroupNorm -> swish -> 3x3 conv to 3 channels."""
    F = P.nn.functional

    def norm(c):
        return P.nn.GroupNorm(32, c)

    def conv3(cin, cout, stride=1):
        return P.nn.Conv2D(cin, cout, 3, stride=stride, padding=1)

    class ResBlock(P.nn.Layer):
        def __init__(self, cin, cout):
            super().__init__()
            self.norm1, self.conv1 = norm(cin), conv3(cin, cout)
            self.temb = P.nn.Linear(4 * ch, cout)
            self.norm2, self.conv2 = norm(cout), conv3(cout, cout)
            self.dropout = P.nn.Dropout(dropout)
            self.skip = (P.nn.Conv2D(cin, cout, 1) if cin != cout
                         else P.nn.Identity())

        def forward(self, x, temb):
            h = self.conv1(F.swish(self.norm1(x)))
            h = h + P.unsqueeze(self.temb(F.swish(temb)), [2, 3])
            h = self.conv2(self.dropout(F.swish(self.norm2(h))))
            return self.skip(x) + h

    class AttnBlock(P.nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.norm = norm(c)
            self.q, self.k = P.nn.Linear(c, c), P.nn.Linear(c, c)
            self.v, self.proj = P.nn.Linear(c, c), P.nn.Linear(c, c)

        def forward(self, x):
            b, c, h, w = x.shape
            t = P.transpose(P.reshape(self.norm(x), [b, c, h * w]),
                            [0, 2, 1])
            q, k, v = (P.unsqueeze(f(t), 2) for f in (self.q, self.k,
                                                      self.v))
            a = P.reshape(F.scaled_dot_product_attention(q, k, v),
                          [b, h * w, c])
            a = P.reshape(P.transpose(self.proj(a), [0, 2, 1]), [b, c, h, w])
            return x + a

    class UNet(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.temb1 = P.nn.Linear(ch, 4 * ch)
            self.temb2 = P.nn.Linear(4 * ch, 4 * ch)
            self.conv_in = conv3(3, ch)
            self.down = P.nn.LayerList()
            widths, c, res = [ch], ch, image
            for i, m in enumerate(ch_mult):
                for _ in range(num_res):
                    self.down.append(ResBlock(c, ch * m))
                    c = ch * m
                    if res in attn_res:
                        self.down.append(AttnBlock(c))
                    widths.append(c)
                if i != len(ch_mult) - 1:
                    self.down.append(conv3(c, c, 2))
                    widths.append(c)
                    res //= 2
            self.mid = P.nn.LayerList([ResBlock(c, c), AttnBlock(c),
                                       ResBlock(c, c)])
            self.up = P.nn.LayerList()
            for i, m in reversed(list(enumerate(ch_mult))):
                for _ in range(num_res + 1):
                    self.up.append(ResBlock(c + widths.pop(), ch * m))
                    c = ch * m
                    if res in attn_res:
                        self.up.append(AttnBlock(c))
                if i != 0:
                    self.up.append(conv3(c, c))
                    res *= 2
            self.norm_out, self.conv_out = norm(c), conv3(c, 3)

        def time_embedding(self, t):
            half = ch // 2
            freq = P.exp(P.arange(half, dtype="float32")
                         * (-math.log(10000.0) / (half - 1)))
            arg = P.unsqueeze(P.cast(t, "float32"), 1) * P.unsqueeze(freq, 0)
            emb = P.concat([P.sin(arg), P.cos(arg)], 1)
            return self.temb2(F.swish(self.temb1(emb)))

        def forward(self, x, t):
            temb = self.time_embedding(t)
            hs = [self.conv_in(x)]
            h = hs[-1]
            for layer in self.down:
                if isinstance(layer, ResBlock):
                    h = layer(h, temb)
                elif isinstance(layer, AttnBlock):
                    h = layer(h)
                    hs[-1] = h
                    continue
                else:
                    h = layer(h)
                hs.append(h)
            h = self.mid[2](self.mid[1](self.mid[0](h, temb)), temb)
            for layer in self.up:
                if isinstance(layer, ResBlock):
                    h = layer(P.concat([h, hs.pop()], 1), temb)
                elif isinstance(layer, AttnBlock):
                    h = layer(h)
                else:
                    h = layer(F.interpolate(h, scale_factor=2,
                                            mode="nearest"))
            return self.conv_out(F.swish(self.norm_out(h)))

    return UNet()


def ddpm_schedule(steps, beta_1, beta_t):
    """Ho et al.'s linear betas and the products DDPM's loss and sampler
    read, float32 arrays of `steps` entries."""
    betas = np.linspace(beta_1, beta_t, steps, dtype=np.float64)
    alphas_bar = np.cumprod(1.0 - betas)
    return {k: v.astype(np.float32) for k, v in dict(
        betas=betas, sqrt_ab=np.sqrt(alphas_bar),
        sqrt_1mab=np.sqrt(1.0 - alphas_bar),
        recip_sqrt_a=1.0 / np.sqrt(1.0 - betas),
        eps_coef=betas / np.sqrt(1.0 - alphas_bar),
        sigma=np.sqrt(betas)).items()}


def _at(P, table, t):
    """table[t] as (b, 1, 1, 1)."""
    return P.reshape(P.gather(table, t), [-1, 1, 1, 1])


def ddpm_loss(P, model, x0, t, noise, sched):
    """Ho et al.'s simplified objective: the MSE between the noise and
    the model's prediction of it from sqrt(ab_t) x0 + sqrt(1 - ab_t) noise."""
    x_t = _at(P, sched["sqrt_ab"], t) * x0 + _at(P, sched["sqrt_1mab"],
                                                  t) * noise
    return P.nn.functional.mse_loss(model(x_t, t), noise)


def ddpm_sample_step(P, model, x, t, z, sched):
    """One step of ancestral sampling (Ho et al., Algorithm 2, sigma_t^2 =
    beta_t): 1 / sqrt(a_t) (x - beta_t / sqrt(1 - ab_t) eps) + sigma_t z,
    with z zero at t = 0."""
    eps = model(x, t)
    mean = _at(P, sched["recip_sqrt_a"], t) * (
        x - _at(P, sched["eps_coef"], t) * eps)
    return mean + _at(P, sched["sigma"], t) * z



# phase 21 (a): ViT-Base/16 (Dosovitskiy et al. 2021, Table 1) trained as
# DeiT-B (Touvron et al. 2021, Table 9): AdamW, weight decay 0.05, lr
# 5e-4 x batch / 512 under a cosine schedule over 300 epochs, label
# smoothing 0.1, stochastic depth 0.1, mixup alpha 0.8, no dropout; bf16,
# b64 a card, 1 + 8 steps. Its float32 twin at 2 layers and full widths,
# drop path off, TF32 off, on the card and the CPU with the same weights
# and batch: the same float32 math summed in other orders; the loss, about
# ln(1000) = 6.9, moves by a few float32 roundings of it, the gradient
# norm by a few more (sums over 8 x 197 tokens per weight)
VIT = dict(image=224, patch=16, dim=768, depth=12, heads=12, mlp=3072,
           classes=1000, drop_path=0.1)
VIT_BATCH, VIT_STEPS, VIT_MIXUP, VIT_SMOOTHING = 64, 8, 0.8, 0.1
VIT_LR, VIT_WD, VIT_EPOCHS = 5e-4 * 64 / 512, 0.05, 300
VIT_TWIN_DEPTH, VIT_TWIN_BATCH = 2, 8
VIT_TWIN_LOSS_RTOL, VIT_TWIN_GRAD_RTOL = 1e-4, 1e-3
VIT_TOKENS = (224 // 16) ** 2 + 1
# ViT-B/16's attention: 64 images, 12 heads of 64 over 197 tokens, no
# mask, not causal (phases 3 and 5 hold K1 and K3/K4 at it)
# (b) DDPM on CIFAR-10 (Ho et al. 2020, App. B; diffusion_tf's
# scripts/run_cifar.py): ch 128, ch_mult (1, 2, 2, 2), 2 residual blocks a
# level, attention at 16 x 16, dropout 0.1, T = 1000 linear betas 1e-4 to
# 0.02, Adam(2e-4), batch 128 at 32 x 32, float32; 1 + 4 training steps,
# then 20 ancestral sampling steps at batch 16. Its float32 twin at
# ch_mult (1, 2) and full channel width, dropout off, TF32 off, batch 8,
# on the card and the CPU: the loss (an MSE near 1) and the gradient norm
# as (a)'s, and one sampling step's output within DDPM_TWIN_SAMPLE_RTOL of
# the largest |value| (a few float32 roundings of the 3x3 convolutions'
# sums)
DDPM = dict(ch=128, ch_mult=(1, 2, 2, 2), num_res=2, attn_res=(16,),
            dropout=0.1, image=32)
DDPM_T, DDPM_BETAS, DDPM_LR = 1000, (1e-4, 0.02), 2e-4
DDPM_BATCH, DDPM_STEPS = 128, 4
DDPM_SAMPLE_BATCH, DDPM_SAMPLE_STEPS = 16, 20
DDPM_TWIN_MULT, DDPM_TWIN_BATCH = (1, 2), 8
DDPM_TWIN_LOSS_RTOL, DDPM_TWIN_GRAD_RTOL = 1e-4, 1e-3
DDPM_TWIN_SAMPLE_RTOL = 1e-4
# (c) the new ops on the card against the port's CPU result on the same
# inputs: float32 results (TF32 off) are the same math in other orders
# and algorithms (cuSOLVER against LAPACK, the card's special-function
# series against the CPU's), relative to the largest |value|
NEW_OPS_RTOL = 1e-4
NEW_OPS_DRAWS = 100000


def vit_batch(seed, batch, image, classes):
    """Images N(0, 1) (normalized pixels), labels, a mixup permutation
    and lambda ~ Beta(0.8, 0.8), from numpy's default_rng(seed)."""
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((batch, 3, image, image)).astype(np.float32)
    return (images, rng.integers(0, classes, batch), rng.permutation(batch),
            float(rng.beta(VIT_MIXUP, VIT_MIXUP)))


def phase_vit():
    """(a) DeiT-B training; returns K1/K3/K4 launches over the timed
    steps."""
    gc.collect()
    torch.cuda.empty_cache()
    pt.seed(0)
    model = vit(pt, **VIT).to(torch.bfloat16)
    sched = optimizer.lr.CosineAnnealingDecay(VIT_LR, VIT_EPOCHS)
    opt = optimizer.AdamW(learning_rate=sched, weight_decay=VIT_WD,
                          parameters=model.parameters())
    images, labels, perm, lam = vit_batch(0, VIT_BATCH, VIT["image"],
                                          VIT["classes"])
    x = torch.tensor(images, device="cuda", dtype=torch.bfloat16)
    y = torch.tensor(labels, device="cuda")
    p = torch.tensor(perm, device="cuda")

    def step():
        loss = vit_loss(pt, model, x, y, p, lam, VIT["classes"],
                        VIT_SMOOTHING)
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        return loss.detach()

    route = ar.route(VIT_BATCH * VIT["heads"], VIT_TOKENS, VIT_TOKENS,
                     VIT["dim"] // VIT["heads"], torch.bfloat16, False,
                     platform="cuda")
    first = float(step())                     # warm-up
    zero_flash_launches()                     # the path starts here
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = timed_steps(step, VIT_STEPS)
    launches = train_llama.launch_counts()    # the path ends here
    peak = torch.cuda.max_memory_allocated()
    by_class = kernel_ms_by_class(step)
    flops, macs = vit_flops(model, VIT_BATCH, VIT_TOKENS, VIT["dim"],
                            VIT["depth"])
    n_params = sum(q.numel() for q in model.parameters())
    mfu = flops / (step_ms / 1e3) / BF16_FLOP_PER_S
    per_step = {k: v // VIT_STEPS for k, v in launches.items()}
    log(f"vit deit-b [{CARD}]: ViT-B/16, {n_params} params, b{VIT_BATCH} "
        f"x 224^2 bf16, AdamW(wd {VIT_WD}) under CosineAnnealingDecay, "
        f"mixup lambda {lam:.4f}, label smoothing {VIT_SMOOTHING}, drop "
        f"path {VIT['drop_path']}; step {step_ms:.2f} ms ({VIT_STEPS} timed "
        f"after 1), {VIT_BATCH / step_ms * 1e3:.1f} images/s, MFU "
        f"{mfu:.4f} = {flops / 1e12:.4f} TFLOP a step [6 x ({macs / 1e9:.3f}"
        f" G multiply-adds an image forward: weights x tokens + 2 s^2 d a "
        f"block) x batch] / step s / {BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s; "
        f"peak memory {peak / 2**30:.2f} GiB")
    log(f"vit deit-b: router at the attention (bh={VIT_BATCH * VIT['heads']}"
        f", s={VIT_TOKENS}, d64, not causal): fwd={route.fwd} "
        f"bwd={route.bwd} source={route.source}; launches per step "
        f"{per_step}")
    log(f"vit deit-b, one traced step: {class_line(by_class)}; busy "
        f"{sum(by_class.values()) / step_ms:.1%} of the timed steps' mean")
    log(f"vit deit-b: losses {[first] + losses}")
    fwd = route.fwd == "pallas"
    bwd = fwd and route.bwd == "pallas"
    depth = VIT["depth"]
    want = {"flash_fwd": depth if fwd else 0,
            "flash_bwd_dq": depth if bwd else 0,
            "flash_bwd_dkv": depth if bwd else 0}
    if not all(np.isfinite([first] + losses)):
        sys.exit("chip_smoke: a ViT loss is not finite")
    if per_step != want or any(v % VIT_STEPS for v in launches.values()):
        sys.exit(f"chip_smoke: the ViT launched {launches} over {VIT_STEPS} "
                 f"steps, expected {want} a step")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def twin_check(name, out, loss_rtol, grad_rtol):
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    norm_err = abs(out["cuda"][1] - out["cpu"][1]) / out["cpu"][1]
    log(f"{name}: loss card {out['cuda'][0]:.7f} CPU {out['cpu'][0]:.7f} "
        f"(rel err {loss_err:.3e}, tol {loss_rtol}); grad norm card "
        f"{out['cuda'][1]:.7f} CPU {out['cpu'][1]:.7f} (rel err "
        f"{norm_err:.3e}, tol {grad_rtol})")
    if not (loss_err <= loss_rtol and norm_err <= grad_rtol):
        sys.exit(f"chip_smoke: {name} on the card disagrees with the CPU")


def grad_norm(model):
    return float(torch.sqrt(sum(q.grad.double().square().sum()
                                for q in model.parameters()
                                if q.grad is not None)))


def phase_vit_twin():
    """(a)'s float32 twin at 2 layers and full widths, drop path off."""
    pt.seed(0)
    model = vit(pt, **dict(VIT, depth=VIT_TWIN_DEPTH, drop_path=0.0))
    images, labels, perm, lam = vit_batch(1, VIT_TWIN_BATCH, VIT["image"],
                                          VIT["classes"])
    out = {}
    for dev in ("cuda", "cpu"):
        m = model.to(dev)
        loss = vit_loss(pt, m, torch.tensor(images, device=dev),
                        torch.tensor(labels, device=dev),
                        torch.tensor(perm, device=dev), lam, VIT["classes"],
                        VIT_SMOOTHING)
        loss.backward()
        out[dev] = (float(loss.detach()), grad_norm(m))
        m.clear_gradients()
    twin_check(f"vit twin (float32, {VIT_TWIN_DEPTH} layers, d768, b"
               f"{VIT_TWIN_BATCH}, drop path off, TF32 off, dense attention)",
               out, VIT_TWIN_LOSS_RTOL, VIT_TWIN_GRAD_RTOL)


def ddpm_tables(device):
    return {k: torch.tensor(v, device=device) for k, v in
            ddpm_schedule(DDPM_T, *DDPM_BETAS).items()}


def phase_ddpm():
    """(b) DDPM: 1 + 4 training steps at b128, then 20 ancestral sampling
    steps at b16; returns the flash kernels' launches (none is on this
    path: the attention's one head of 256 takes the dense path)."""
    gc.collect()
    torch.cuda.empty_cache()
    pt.seed(0)
    model = ddpm_unet(pt, **DDPM)
    opt = optimizer.Adam(learning_rate=DDPM_LR,
                         parameters=model.parameters())
    sched = ddpm_tables("cuda")
    x0 = torch.tensor(np.random.default_rng(2).uniform(
        -1, 1, (DDPM_BATCH, 3, 32, 32)).astype(np.float32), device="cuda")

    def step():
        t = pt.randint(0, DDPM_T, [DDPM_BATCH])
        noise = pt.randn([DDPM_BATCH, 3, 32, 32])
        loss = ddpm_loss(pt, model, x0, t, noise, sched)
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss.detach()

    first = float(step())
    zero_flash_launches()                     # the path starts here
    torch.cuda.reset_peak_memory_stats()
    step_ms, losses = timed_steps(step, DDPM_STEPS)
    train_peak = torch.cuda.max_memory_allocated()
    by_class = kernel_ms_by_class(step, resnet_class)
    model.eval()
    x = pt.randn([DDPM_SAMPLE_BATCH, 3, 32, 32])

    def sample(x, n):
        for i in range(n):
            t = torch.full((DDPM_SAMPLE_BATCH,), DDPM_T - 1 - i,
                           device="cuda")
            x = ddpm_sample_step(pt, model, x, t, pt.randn(list(x.shape)),
                                 sched)
        return x

    with torch.no_grad():
        sample(x, 1)                          # warm-up
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sample(x, DDPM_SAMPLE_STEPS)
        torch.cuda.synchronize()
        sample_ms = (time.perf_counter() - t0) * 1e3 / DDPM_SAMPLE_STEPS
        sample_peak = torch.cuda.max_memory_allocated()
        sample_class = kernel_ms_by_class(lambda: sample(x, 1),
                                          resnet_class)
    launches = train_llama.launch_counts()    # the path ends here
    n_params = sum(q.numel() for q in model.parameters())
    log(f"ddpm cifar10 [{CARD}]: U-Net {n_params} params (ch 128, ch_mult "
        f"(1, 2, 2, 2), 2 blocks a level, attention at 16^2, dropout 0.1), "
        f"b{DDPM_BATCH} x 32^2 float32, Adam({DDPM_LR}); train step "
        f"{step_ms:.2f} ms ({DDPM_STEPS} timed after 1), "
        f"{DDPM_BATCH / step_ms * 1e3:.1f} images/s, peak memory "
        f"{train_peak / 2**30:.2f} GiB; losses {[first] + losses}")
    log(f"ddpm, one traced train step: {class_line(by_class)}; busy "
        f"{sum(by_class.values()) / step_ms:.1%} of the timed steps' mean")
    log(f"ddpm sampling [{CARD}]: b{DDPM_SAMPLE_BATCH}, {DDPM_SAMPLE_STEPS} "
        f"ancestral steps from t = {DDPM_T - 1}: {sample_ms:.3f} ms a step, "
        f"peak memory {sample_peak / 2**30:.2f} GiB; one traced step: "
        f"{class_line(sample_class)}; busy "
        f"{sum(sample_class.values()) / sample_ms:.1%}; launches {launches}")
    if not all(np.isfinite([first] + losses)):
        sys.exit("chip_smoke: a DDPM loss is not finite")
    if not (tuple(out.shape) == (DDPM_SAMPLE_BATCH, 3, 32, 32)
            and bool(torch.isfinite(out).all())):
        sys.exit("chip_smoke: DDPM sampling gave a wrong shape or a "
                 "non-finite value")
    if any(launches.values()):
        sys.exit("chip_smoke: the DDPM path launched a flash kernel")
    del model, opt
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_ddpm_twin():
    """(b)'s float32 twin at ch_mult (1, 2), dropout off: one training
    step's loss and gradient norm, and one sampling step's output, on the
    card against the CPU."""
    pt.seed(0)
    model = ddpm_unet(pt, **dict(DDPM, ch_mult=DDPM_TWIN_MULT, dropout=0.0))
    rng = np.random.default_rng(3)
    shape = (DDPM_TWIN_BATCH, 3, 32, 32)
    x0 = rng.uniform(-1, 1, shape).astype(np.float32)
    noise = rng.standard_normal(shape).astype(np.float32)
    z = rng.standard_normal(shape).astype(np.float32)
    t = rng.integers(0, DDPM_T, DDPM_TWIN_BATCH)
    out, samples = {}, {}
    for dev in ("cuda", "cpu"):
        pt.set_device(dev)                    # where P.arange builds
        m = model.to(dev)
        m.train()
        sched = ddpm_tables(dev)
        loss = ddpm_loss(pt, m, torch.tensor(x0, device=dev),
                         torch.tensor(t, device=dev),
                         torch.tensor(noise, device=dev), sched)
        loss.backward()
        out[dev] = (float(loss.detach()), grad_norm(m))
        m.clear_gradients()
        m.eval()
        with torch.no_grad():
            samples[dev] = ddpm_sample_step(
                pt, m, torch.tensor(noise, device=dev),
                torch.tensor(t, device=dev), torch.tensor(z, device=dev),
                sched).cpu()
    pt.set_device("cuda")
    twin_check(f"ddpm twin (float32, ch 128, ch_mult {DDPM_TWIN_MULT}, b"
               f"{DDPM_TWIN_BATCH}, dropout off, TF32 off)", out,
               DDPM_TWIN_LOSS_RTOL, DDPM_TWIN_GRAD_RTOL)
    err = float((samples["cuda"] - samples["cpu"]).abs().max()
                / samples["cpu"].abs().max())
    log(f"ddpm twin sampling step: card against CPU {err:.3e} of the "
        f"largest |value| (tol {DDPM_TWIN_SAMPLE_RTOL})")
    if not err <= DDPM_TWIN_SAMPLE_RTOL:
        sys.exit("chip_smoke: the DDPM sampling step on the card disagrees "
                 "with the CPU")


def new_op_inputs():
    """The CPU tests' kinds of input, from numpy's default_rng(0)."""
    r = np.random.default_rng(0)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    m = f(4, 4)
    spd = (m @ m.T + 4 * np.eye(4)).astype(np.float32)
    return dict(
        X=f(3, 4), Y=f(3, 4), P=(r.random((3, 4)) * 2 + 0.1).astype(
            np.float32),
        U=(r.random((3, 4)) * 1.8 - 0.9).astype(np.float32),
        G=(r.random((3, 4)) * 2 + 1.1).astype(np.float32),
        I=r.integers(1, 9, (3, 4)), J=r.integers(1, 9, (3, 4)),
        M=m, SPD=spd, L=np.linalg.cholesky(spd).astype(np.float32),
        TALL=f(6, 3), B=f(4, 2), B6=f(6, 2), V=f(4), X3=f(2, 3, 4),
        U3=f(5, 3), H=(r.random(200) * 4 - 1).astype(np.float32),
        PTS=f(50, 2), IMG=f(2, 3, 8, 8), IMG5=f(1, 2, 5, 6), X4=f(2, 6, 5, 5),
        X2=f(4, 6), Y2=f(4, 6), SEQ=f(2, 3, 7), VOL=f(1, 2, 4, 5, 6),
        QKV=f(2, 9, 3, 2, 8), PACK=f(10, 2, 8), Q4=f(2, 2, 6, 8),
        RNNT=f(2, 4, 3, 5), GRID=r.uniform(-1.2, 1.2, (2, 4, 5, 2)).astype(
            np.float32),
        LOW=(f(8, 2) @ f(2, 6)).astype(np.float32),
        NANS=np.where(r.random((3, 4)) > 0.3, f(3, 4), np.nan).astype(
            np.float32),
        COS=np.tanh(f(4, 6)), LAB=np.array([2, 0, 5, 1]))


_UNARY_DOMAIN = {
    "acos": "U", "acosh": "G", "asin": "U", "atanh": "U", "digamma": "P",
    "erfinv": "U", "lgamma": "P", "log": "P", "log10": "P", "log1p": "P",
    "log2": "P", "reciprocal": "P", "rsqrt": "P", "sqrt": "P", "tan": "U",
    "logit": "U", "gammaln": "P", "sinc": "X", "polygamma": "P",
    "multigammaln": "G"}


def new_op_specs(d):
    """(family, name, callable(P-args) spec) of every function this slice
    ported: each as (family, name, args, kwargs, how) with numpy arrays
    among args, and how "value" (compared as it is), "random" (support and
    moments) or a function giving the unique parts of a decomposition."""
    T = lambda k: d[k]
    specs = []
    add = lambda fam, name, args, kw=None, how="value": specs.append(
        (fam, name, args, kw or {}, how))
    from paddle_tpu_torch.tensor import math as tmath
    skip = {"matmul", "mm", "bmm", "einsum"}
    binary = {"add", "subtract", "multiply", "divide", "floor_divide", "mod",
              "remainder", "pow", "maximum", "minimum", "fmax", "fmin",
              "atan2", "logaddexp", "hypot", "copysign", "nextafter",
              "heaviside", "inner", "kron"}
    special = {
        "floor_mod": ([T("I"), T("J")], {}), "gcd": ([T("I"), T("J")], {}),
        "lcm": ([T("I"), T("J")], {}), "ldexp": ([T("X"), T("I")], {}),
        "outer": ([T("V"), T("V")], {}), "pow": ([T("P"), T("X")], {}),
        "scale": ([T("X")], dict(scale=2.0, bias=0.5)),
        "clip": ([T("X")], dict(min=-0.5, max=0.5)),
        "lerp": ([T("X"), T("Y"), 0.3], {}),
        "addmm": ([T("X"), T("X"), T("M")], dict(beta=0.5, alpha=2.0)),
        "multiplex": ([[T("X"), T("Y")], np.array([[1], [0], [1]])], {}),
        "nan_to_num": ([T("NANS")], {}), "count_nonzero": ([T("I")], {}),
        "cumsum": ([T("X")], dict(axis=1)), "cumprod": ([T("X")],
                                                        dict(dim=0)),
        "cummax": ([np.round(T("X"))], dict(axis=1)),
        "cummin": ([np.round(T("X"))], dict(axis=0)),
        "trapezoid": ([T("X")], dict(dx=0.5)),
        "cumulative_trapezoid": ([T("X")], {}),
        "diff": ([T("X")], dict(axis=1)), "dot": ([T("X"), T("Y")], {}),
        "isclose": ([T("X"), T("Y")], {}), "allclose": ([T("X"), T("X")],
                                                        {}),
        "increment": ([T("X")], {}),
        "accuracy": ([T("X"), np.array([[1], [0], [3]])], dict(k=2)),
        "nanmean": ([T("NANS")], dict(axis=1)), "nansum": ([T("NANS")], {}),
        "logit": ([T("P") / 3], {}), "conj": ([T("X")], {}),
    }
    for name in tmath.__all__:
        if name in skip:
            continue
        if name in special:
            args, kw = special[name]
        elif name in binary:
            args, kw = [T("X"), T("P") if name in ("divide", "floor_divide",
                                                   "mod", "remainder")
                        else T("Y")], {}
        else:
            args, kw = [T(_UNARY_DOMAIN.get(name, "X"))], {}
        add("math", name, args, kw)
    for name, args, kw in [
            ("std", [T("X")], {}), ("var", [T("X")], dict(axis=1)),
            ("median", [T("X")], dict(axis=1)),
            ("median", [T("X")], dict(axis=1, mode="min")),
            ("nanmedian", [T("NANS")], dict(axis=1)),
            ("quantile", [T("X")], dict(q=[0.1, 0.5], axis=1)),
            ("nanquantile", [T("NANS")], dict(q=0.4, axis=1))]:
        add("stat", name, args, kw)
    n = NEW_OPS_DRAWS
    ones = np.ones(n, np.float32)
    for name, args, kw, support, mean in [
            ("rand", [[n]], {}, (0, 1), 0.5), ("randn", [[n]], {}, None, 0.0),
            ("standard_normal", [[n]], {}, None, 0.0),
            ("normal", [1.0, 2.0, [n]], {}, None, 1.0),
            ("uniform", [[n]], dict(min=2.0, max=4.0), (2, 4), 3.0),
            ("randint", [3, 10, [n]], {}, (3, 10), 6.0),
            ("randint_like", [ones, 0, 4], {}, (0, 4), 1.5),
            ("randperm", [n], {}, (0, n), (n - 1) / 2),
            ("bernoulli", [ones * 0.3], {}, (0, 1.01), 0.3),
            ("poisson", [ones * 4], {}, (0, 100), 4.0),
            ("standard_gamma", [ones * 2], {}, (0, 100), 2.0),
            ("binomial", [ones * 10, ones * 0.4], {}, (0, 10.01), 4.0),
            ("log_normal", [0.0, 0.5, [n]], {}, (0, 100), math.exp(0.125)),
            ("multinomial", [np.array([0.2, 0.8], np.float32), n],
             dict(replacement=True), (0, 2), 0.8),
            ("gumbel_softmax", [np.zeros((n, 2), np.float32)], {}, (0, 1.01),
             0.5),
            ("normal_", [np.zeros(n, np.float32), 1.0, 0.5], {}, None, 1.0),
            ("uniform_", [np.zeros(n, np.float32), -2.0, 2.0], {}, (-2, 2),
             0.0),
            ("bernoulli_", [np.zeros(n, np.float32), 0.25], {}, (0, 1.01),
             0.25),
            ("exponential_", [np.zeros(n, np.float32), 2.0], {}, (0, 100),
             0.5),
            ("log_normal_", [np.zeros(n, np.float32), 0.0, 0.5], {},
             (0, 100), math.exp(0.125)),
            ("geometric_", [np.zeros(n, np.float32), 0.25], {}, (1, 1000),
             4.0),
            ("cauchy_", [np.zeros(n, np.float32), 0.0, 1.0], {}, None, None)]:
        add("random", name, args, kw, ("random", support, mean))
    lin = [
        ("t", [T("X")], {}), ("transpose_last2", [T("X3")], {}),
        ("matrix_transpose", [T("X3")], {}),
        ("norm", [T("X")], dict(p="fro")), ("norm", [T("X3")],
                                            dict(p=1, axis=[1, 2])),
        ("dist", [T("X"), T("Y")], dict(p=3)), ("cond", [T("SPD")], {}),
        ("matrix_power", [T("M")], dict(n=3)),
        ("matrix_rank", [T("LOW")], {}), ("det", [T("M")], {}),
        ("slogdet", [T("M")], {}), ("inv", [T("SPD")], {}),
        ("inverse", [T("SPD")], {}), ("pinv", [T("TALL")], {}),
        ("solve", [T("SPD"), T("B")], {}),
        ("triangular_solve", [T("L"), T("B")], dict(upper=False)),
        ("cholesky", [T("SPD")], {}), ("cholesky_solve", [T("B"), T("L")],
                                       {}),
        ("svdvals", [T("TALL")], {}), ("eigvalsh", [T("SPD")], {}),
        ("lstsq", [T("TALL"), T("B6")], {}),
        ("multi_dot", [[T("X"), T("M"), T("M")]], {}),
        ("cross", [T("U3"), T("U3")[::-1].copy()], {}),
        ("histogram", [T("H")], dict(bins=7)),
        ("histogramdd", [T("PTS")], dict(bins=3)),
        ("bincount", [T("I").reshape(-1)], {}), ("mv", [T("M"), T("V")], {}),
        ("corrcoef", [T("X")], {}), ("cov", [T("X")], {}),
        ("vecdot", [T("X"), T("Y")], {}),
        ("tensordot", [T("X3"), T("X").T.copy()], dict(axes=1)),
        ("linalg.cholesky_inverse", [T("L")], {}),
        ("linalg.matrix_norm", [T("X3")], dict(p="nuc")),
        ("linalg.vector_norm", [T("X")], dict(p=3.0, axis=1)),
        ("linalg.matrix_exp", [T("M") / 4], {})]
    for name, args, kw in lin:
        add("linalg", name, args, kw)
    qr_a, tau = np.linalg.qr(T("TALL"), mode="raw")
    hh = [qr_a.T.copy().astype(np.float32), tau.astype(np.float32)]
    add("linalg", "householder_product", hh)
    add("linalg", "linalg.ormqr", hh + [T("B6")])
    recon = lambda u, s, v: u[..., :s.shape[-1]] @ torch.diag_embed(s) @ \
        v[..., :s.shape[-1]].mT
    for name, args, kw, unique in [
            ("svd", [T("TALL")], {}, lambda o: [o[1], recon(*o)]),
            ("qr", [T("TALL")], {}, lambda o: [o[1].abs(), o[0] @ o[1]]),
            ("eigh", [T("SPD")], {}, lambda o: [
                o[0], o[1] @ torch.diag(o[0]) @ o[1].T]),
            ("eig", [T("M")], {}, lambda o: [torch.sort(o[0].real).values,
                                             torch.sort(o[0].imag).values]),
            ("eigvals", [T("M")], {}, lambda o: [torch.sort(o.real).values]),
            ("lu", [T("M")], {}, lambda o: [
                (lambda p, lo, up: p @ lo @ up)(*pt.lu_unpack(*o))]),
            ("lu_unpack", list(torch.linalg.lu_factor(torch.tensor(T("M")))),
             {}, lambda o: [o[0] @ o[1] @ o[2]]),
            ("pca_lowrank", [T("LOW")], dict(q=2), lambda o: [
                o[1], recon(*o)]),
            ("linalg.svd_lowrank", [T("LOW")], dict(q=3),
             lambda o: [recon(*o)])]:
        add("linalg", name, args, kw, unique)
    ext = [
        ("add_n", [[T("X"), T("Y")]], {}), ("block_diag", [[T("M"), T("V")]],
                                            {}),
        ("broadcast_shape", [[3, 1, 4], [5, 1]], {}),
        ("cartesian_prod", [[T("V"), T("V")]], {}),
        ("cdist", [T("X"), T("Y")], {}), ("combinations", [T("V")], {}),
        ("diag_embed", [T("X")], {}), ("frexp", [T("X") * 100], {}),
        ("gammainc", [T("P"), T("G")], {}), ("gammaincc", [T("P"), T("G")],
                                             {}),
        ("gammaln", [T("P")], {}), ("histogram_bin_edges", [T("X")],
                                    dict(bins=6)),
        ("index_fill", [T("X"), np.array([0, 2]), 1, 9.0], {}),
        ("isin", [T("I"), np.array([1, 3])], {}),
        ("logcumsumexp", [T("X")], dict(axis=1)),
        ("masked_scatter", [T("X"), T("X") > 0,
                            np.arange(12, dtype=np.float32)], {}),
        ("multigammaln", [T("G") + 2], dict(p=3)), ("pdist", [T("Y")], {}),
        ("polygamma", [T("P")], dict(n=2)),
        ("reduce_as", [np.stack([T("X"), T("X")]), T("X")[:1]], {}),
        ("renorm", [T("X")], dict(p=2.0, axis=0, max_norm=1.0)),
        ("reverse", [T("X")], dict(axis=1)), ("sgn", [T("X")], {}),
        ("signbit", [T("X")], {}), ("sinc", [T("X")], {}),
        ("take", [T("X"), np.array([0, 5, -1])], {}),
        ("trace", [T("X")], {}), ("vander", [T("V")], {}),
        ("as_strided", [T("X"), [2, 3], [1, 4]], dict(offset=1))]
    for name, args, kw in ext:
        add("extras", name, args, kw)
    from paddle_tpu_torch import tensor as ptensor
    for name in ptensor._INPLACE + ["where_"]:
        base = name[:-1]
        got = [s for s in specs if s[1] == base and s[4] == "value"]
        if name == "where_":
            args = [T("X") > 0, T("X"), T("Y")]
            kw = {}
        elif got:
            args, kw = got[0][2], got[0][3]
        elif base in ("equal", "not_equal", "greater_equal", "greater_than",
                      "less_equal", "less_than"):
            args, kw = [T("X"), T("Y")], {}
        elif base.startswith(("bitwise", "logical")):
            args, kw = ([T("I")] if base.endswith("not")
                        else [T("I"), T("J")]), {}
        elif base == "cast":
            args, kw = [T("X"), "int64"], {}
        elif base == "transpose":
            args, kw = [T("X"), [1, 0]], {}
        elif base in ("tril", "triu"):
            args, kw = [T("M")], {}
        elif base == "masked_fill":
            args, kw = [T("X"), T("X") > 0, 2.0], {}
        elif base == "index_add":
            args, kw = [T("X"), np.array([0, 2]), 0, T("Y")[:2]], {}
        elif base == "index_put":
            args, kw = [T("X"), (np.array([0, 2]),), T("Y")[:2]], {}
        elif base in ("put_along_axis", "scatter"):
            idx = np.array([[1, 0, 2, 1]])
            args, kw = ([T("X"), idx, T("Y")[:1], 0] if base ==
                        "put_along_axis" else
                        [T("X"), np.array([2, 0]), T("Y")[:2]]), {}
        else:
            raise SystemExit(f"chip_smoke: no input for {name}")
        add("inplace", name, args, kw)
    F = "nn.functional."
    nn_specs = [
        ("elu", [T("X2")], dict(alpha=0.7)), ("selu", [T("X2")], {}),
        ("celu", [T("X2")], {}), ("softplus", [T("X2")], {}),
        ("softshrink", [T("X2")], {}), ("hardshrink", [T("X2")], {}),
        ("tanhshrink", [T("X2")], {}), ("hardtanh", [T("X2")], {}),
        ("leaky_relu", [T("X2")], {}), ("thresholded_relu", [T("X2")], {}),
        ("prelu", [T("X4"), np.linspace(.1, .6, 6).astype(np.float32)], {}),
        ("rrelu", [T("X2")], {}), ("maxout", [T("X4")], dict(groups=3)),
        ("glu", [T("X2")], {}), ("mish", [T("X2")], {}),
        ("softsign", [T("X2")], {}), ("log_sigmoid", [T("X2")], {}),
        ("sigmoid", [T("X2")], {}), ("relu_", [T("X2")], {}),
        ("elu_", [T("X2")], {}), ("tanh_", [T("X2")], {}),
        ("softmax_", [T("X2")], {}), ("hardtanh_", [T("X2")], {}),
        ("leaky_relu_", [T("X2")], {}), ("thresholded_relu_", [T("X2")], {}),
        ("dropout2d", [T("X4")], dict(training=False)),
        ("dropout3d", [T("VOL")], dict(training=False)),
        ("alpha_dropout", [T("X2")], dict(training=False)),
        ("zeropad2d", [T("IMG5")], dict(padding=[1, 2, 0, 3])),
        ("pad", [T("IMG5"), [1, 1, 2, 0]], dict(mode="reflect")),
        ("one_hot", [T("LAB"), 7], {}),
        ("sequence_mask", [np.array([1, 3, 0])], dict(maxlen=4)),
        ("cosine_similarity", [T("X2"), T("Y2")], {}),
        ("normalize", [T("X4")], {}),
        ("label_smooth", [np.eye(6, dtype=np.float32)[T("LAB")]], {}),
        ("bilinear", [T("X2")[:, :3].copy(), T("Y2")[:, :5].copy(),
                      np.ones((2, 3, 5), np.float32)], {}),
        ("unfold", [T("IMG")], dict(kernel_sizes=[3, 2], strides=2,
                                    paddings=[1, 0, 2, 1])),
        ("fold", [np.ones((2, 12, 16), np.float32)],
         dict(output_sizes=[5, 5], kernel_sizes=2)),
        ("interpolate", [T("IMG5")], dict(size=[7, 9])),
        ("interpolate", [T("IMG")], dict(size=[3, 5], mode="bilinear")),
        ("interpolate", [T("IMG5")], dict(size=[8, 10], mode="bicubic")),
        ("interpolate", [T("IMG5")], dict(size=[8, 4], mode="bilinear",
                                          align_corners=True)),
        ("interpolate", [T("VOL")], dict(size=[3, 7, 4], mode="trilinear",
                                         data_format="NCDHW")),
        ("upsample", [T("IMG5")], dict(scale_factor=2)),
        ("pixel_shuffle", [T("X4")[:, :4].copy()], dict(upscale_factor=2)),
        ("pixel_unshuffle", [T("IMG")], dict(downscale_factor=2)),
        ("channel_shuffle", [T("X4")], dict(groups=3)),
        ("instance_norm", [T("X4")], {}), ("group_norm", [T("X4"), 3], {}),
        ("local_response_norm", [T("X4"), 3], {}),
        ("pairwise_distance", [T("X2"), T("Y2")], {}),
        ("affine_grid", [np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, 0.05]]],
                                  np.float32), [1, 3, 4, 5]], {}),
        ("grid_sample", [T("IMG")[:, :, :6, :7].copy(), T("GRID")], {}),
        ("grid_sample", [T("IMG")[:, :, :6, :7].copy(), T("GRID")],
         dict(mode="nearest", padding_mode="reflection",
              align_corners=False)),
        ("fractional_max_pool2d", [T("IMG"), 3], dict(random_u=0.3)),
        ("fractional_max_pool3d", [T("VOL"), [2, 3, 2]], dict(random_u=0.4)),
        ("temporal_shift", [np.ones((6, 8, 2, 2), np.float32), 3], {}),
        ("feature_alpha_dropout", [T("X4")], dict(training=False)),
        ("multi_margin_loss", [T("COS"), T("LAB")], {}),
        ("hsigmoid_loss", [T("X2"), T("LAB"), 6, np.ones((6, 6),
                                                          np.float32)], {}),
        ("flash_attn_qkvpacked", [T("QKV")], {}),
        ("flash_attn_varlen_qkvpacked", [np.stack([T("PACK")] * 3, 1),
                                         np.array([0, 3, 10], np.int32),
                                         np.array([0, 3, 10], np.int32),
                                         7, 7, 0.35], dict(causal=True)),
        ("flash_attn_unpadded", [T("PACK"), T("PACK"), T("PACK"),
                                 np.array([0, 3, 10], np.int32),
                                 np.array([0, 3, 10], np.int32), 7, 7,
                                 0.35], {}),
        ("flashmask_attention", [T("QKV")[:, :6, 0].copy(),
                                 T("QKV")[:, :6, 1].copy(),
                                 T("QKV")[:, :6, 2].copy()],
         dict(startend_row_indices=np.arange(4, 10, dtype=np.int32).reshape(
             1, 1, 6, 1))),
        ("margin_cross_entropy", [T("COS"), T("LAB")], {}),
        ("class_center_sample", [T("LAB"), 20, 8], {}),
        ("sparse_attention", [None, np.array([0, 1, 3, 4, 6, 7, 9],
                                             np.int32),
                              np.array([0, 0, 1, 2, 1, 3, 4, 2, 5],
                                       np.int32), T("Q4"), T("Q4"),
                              T("Q4")], {}),
        ("rnnt_loss", [T("RNNT"), np.array([[1, 2], [3, 0]], np.int32),
                       np.array([4, 3], np.int32),
                       np.array([2, 1], np.int32)], {}),
        ("adaptive_log_softmax_with_loss", [
            T("X2"), np.array([0, 3, 5, 8]), np.ones((6, 4), np.float32),
            [(np.ones((6, 3), np.float32) / 3, T("X2")[:3, :3].copy()),
             (np.ones((6, 2), np.float32) / 2, T("Y2")[:2, :3].copy())],
            [2, 5]], {})]
    for name, args, kw in nn_specs:
        add("nn", F + name, args, kw)
    return specs


def _on(v, dev):
    """numpy arrays (in lists and tuples too) as tensors on `dev`."""
    if isinstance(v, np.ndarray):
        return torch.tensor(v, device=dev)
    if isinstance(v, torch.Tensor):
        return v.to(dev)
    if isinstance(v, (list, tuple)):
        return type(v)(_on(e, dev) for e in v)
    if isinstance(v, dict):
        return {k: _on(e, dev) for k, e in v.items()}
    return v


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [t for o in out for t in _flat(o)]
    return [out]


def _resolve(path):
    obj = pt
    for part in path.split("."):
        obj = getattr(obj, part)
    return obj


def _gap(a, b):
    """(max |a - b| / max(1, max |b|), exact match needed) of two
    outputs."""
    if not isinstance(b, torch.Tensor):
        return (0.0 if a == b else float("inf")), True
    a = a.detach().cpu()
    b = b.detach().cpu()
    if a.shape != b.shape or a.dtype != b.dtype:
        return float("inf"), True
    if not (b.is_floating_point() or b.is_complex()):
        return (0.0 if torch.equal(a, b) else float("inf")), True
    if a.numel() == 0:
        return 0.0, False
    same_nan = torch.equal(torch.isnan(a), torch.isnan(b))
    a, b = torch.nan_to_num(a), torch.nan_to_num(b)
    scale = max(1.0, float(b.abs().max()))
    gap = float((a - b).abs().max()) / scale
    return (gap if same_nan else float("inf")), False


def phase_new_ops(specs=None, tols=None, label="new ops"):
    """(c) every function this slice ported, once on CUDA on the CPU tests'
    kinds of input, held against the port's CPU result: values as they
    are, random draws by support and moments, decompositions by what is
    unique. `specs` (new_op_specs' form; a name is a path in the port or
    a function) default to phase 21's; `tols` maps a family to its
    tolerance (NEW_OPS_RTOL by default). Returns (family, name, kwargs,
    error) of every spec."""
    t0 = time.perf_counter()
    if specs is None:
        specs = new_op_specs(new_op_inputs())
    tols = tols or {}
    worst, held, problems, rows = {}, {}, [], []
    for fam, name, args, kw, how in specs:
        fn = name if callable(name) else _resolve(name)
        name = getattr(name, "__name__", name)
        tol = tols.get(fam, NEW_OPS_RTOL)
        if isinstance(how, tuple):            # random
            _, support, mean = how
            pt.seed(0)
            v = fn(*_on(args, "cuda"), **_on(kw, "cuda"))
            v = v.detach().float().cpu().reshape(-1)
            v = v[:len(v) // 2 * 2]
            ok = torch.isfinite(v).all() or name == "cauchy_"
            if support is not None:
                ok = ok and bool(((v >= support[0]) & (v < support[1])).all())
            if mean is not None and name != "randperm":
                gap = abs(float(v.mean()) - mean)
                ok = ok and gap <= 5 * max(float(v.std()), 1e-6) / math.sqrt(
                    v.numel())
            if name == "gumbel_softmax":
                ok = ok and v.numel() == 2 * NEW_OPS_DRAWS
            if name == "cauchy_":
                ok = ok and abs(float(v.median())) < 0.05
            err = 0.0 if ok else float("inf")
        else:
            outs = []
            for dev in ("cuda", "cpu"):
                out = fn(*_on(args, dev), **_on(kw, dev))
                outs.append(how(out) if callable(how) else out)
            err = 0.0
            for a, b in zip(_flat(outs[0]), _flat(outs[1])):
                gap, exact = _gap(a, b)
                err = max(err, gap if not exact else (0.0 if gap == 0.0
                                                      else float("inf")))
        rows.append((fam, name, kw, err))
        worst[fam] = max(worst.get(fam, 0.0), err)
        held[fam] = held.get(fam, 0) + (err <= tol)
        if not err <= tol:
            problems.append(f"{fam} {name} {kw} ({err:.3e} > {tol})")
    torch.cuda.synchronize()
    log(f"{label} on the card [{CARD}]: " + "; ".join(
        f"{fam} {held[fam]} held, largest error {worst[fam]:.3e} (tol "
        f"{tols.get(fam, NEW_OPS_RTOL)})" for fam in worst)
        + " of the largest |value| (at least 1); random draws by support "
        f"and mean over {NEW_OPS_DRAWS}; {time.perf_counter() - t0:.1f} s")
    if problems:
        sys.exit(f"chip_smoke: {label} disagree with the CPU: {problems}")
    return rows


def phase_vision():
    """Phase 21: a Vision Transformer and a diffusion U-Net on the card,
    then the slice's new ops; each path's flash kernel launches summed."""
    vit_launches = phase_vit()
    phase_vit_twin()
    ddpm_launches = phase_ddpm()
    phase_ddpm_twin()
    phase_new_ops()
    return {k: vit_launches[k] + ddpm_launches[k] for k in vit_launches}


# -- phase 22: second-order gradients on llama_1.3b -------------------------
# llama_ladder()[0]'s config (24 layers, hidden 2048, 16 heads of 128,
# vocab 32000) in bf16, random weights from seed(0), one sequence of 2048
# tokens: bench.py's b8 cut to b1, as the dense second-order graph holds
# b x 16 x 2048^2 float32 scores a layer (the smallest batch the router
# sends to K1 if it does not send b1)
HVP_SEQ = 2048
HVP_POWER_STEPS = 4
# bf16 gradients: the create_graph backward (the dense forward's) against
# K3/K4's, relative L2 over all parameters
HVP_FIRST_ORDER_RTOL = 3e-2
# Hv through K1's forward against Hv with the dense backend forced
HVP_DENSE_RTOL = 5e-2
# |u.Hv - v.Hu| / (|u| |Hv|)
HVP_SYMMETRY_TOL = 5e-2
# the slice's functions on the card against the CPU, of the largest |value|
# (at least 1): float32 transforms as phase 21's; the dB features take
# log10 of float32 spectra; the fp8 GEMM rounds float32 sums that differ
# in their last bits (cuBLASLt's order against the CPU's) to its output
# dtype, so a value may land one step of that dtype away, up to 2^-10
# (fp16) or 2^-7 (bf16) of the largest value; the transforms of attention
# run in bf16 through K1 and the dense second order on the card, the
# CPU's dense bf16 path
SLICE_TOLS = {"fft": NEW_OPS_RTOL, "signal": NEW_OPS_RTOL,
              "audio": NEW_OPS_RTOL, "audio dB": 1e-3,
              "fp8 gemm fp16": 2.0 ** -10, "fp8 gemm bf16": 2.0 ** -7,
              "autograd": 5e-2}


def hvp_batch(cfg):
    """The smallest batch from 1 whose attention the router sends to K1,
    and its decision."""
    heads = cfg.num_attention_heads
    d = cfg.hidden_size // heads
    for b in range(1, 9):
        dec = ar.route(b * heads, HVP_SEQ, HVP_SEQ, d, torch.bfloat16, True,
                       platform="cuda")
        if dec.fwd == "pallas":
            return b, dec
    sys.exit("chip_smoke: the router sends no batch of llama_1.3b's "
             "attention at s2048 to K1")


def dot(a, b):
    """sum over tensors of a . b, in float32."""
    return sum(float((x.detach().float() * y.detach().float()).sum())
               for x, y in zip(a, b))


def rel_l2(a, b):
    """|a - b| / |b| over lists of tensors, in float32."""
    num = sum(float((x.detach().float() - y.detach().float()).pow(2).sum())
              for x, y in zip(a, b))
    return math.sqrt(num / dot(b, b))


def unit_direction(params, seed):
    """A random direction of the parameters' shapes and dtypes, of unit
    norm, from a CUDA generator seeded with `seed`."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    v = [torch.randn(p.shape, generator=gen, device="cuda",
                     dtype=torch.float32) for p in params]
    norm = math.sqrt(dot(v, v))
    return [(x / norm).to(p.dtype) for x, p in zip(v, params)]


def kernel_launches():
    return dict(flash_fwd=fa.flash_fwd_launches,
                flash_bwd_dq=fa.flash_bwd_dq_launches,
                flash_bwd_dkv=fa.flash_bwd_dkv_launches)


def phase_hvp():
    """Hessian-vector products of llama_1.3b's LM loss through
    paddle_tpu_torch.grad(create_graph=True), as PyHessian takes them:
    the forward through K1 on every layer, the create_graph backward
    through the dense forward's (no K3/K4), each product through it and
    through K1's first-order backward (K3/K4 as routed); power iteration
    for the top eigenvalue.
    Returns the launches of its main path (the ordinary and the
    create_graph runs and the products)."""
    gc.collect()
    torch.cuda.empty_cache()
    dev = pt.device
    name, cfg, *_ = train_llama.llama_ladder()[0]
    n_layers = cfg.num_hidden_layers
    batch, dec = hvp_batch(cfg)
    log(f"hvp {name}: router at (bh {batch * cfg.num_attention_heads}, "
        f"s{HVP_SEQ}, d{cfg.hidden_size // cfg.num_attention_heads}, bf16, "
        f"causal): fwd={dec.fwd} bwd={dec.bwd} [{dec.source}] "
        f"{dec.provenance}")
    pt.seed(0)
    t0 = time.perf_counter()
    model = pt.models.LlamaForCausalLM(cfg, device="cuda")
    params = list(model.parameters())
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, HVP_SEQ), generator=gen,
                        device="cuda")
    torch.cuda.synchronize()
    log(f"hvp {name}: {model.num_params()} params, b{batch} s{HVP_SEQ}, "
        f"built in {time.perf_counter() - t0:.2f} s")
    problems = []

    def expect(what, got, want):
        if got != want:
            problems.append(f"{what}: launched {got}, expected {want}")

    # the ordinary first order: K1 forward, K3/K4 backward
    zero_flash_launches()
    loss0, _ = model(ids, labels=ids)
    loss0.backward()
    launches = kernel_launches()
    bwd = dec.bwd == "pallas"
    expect("loss.backward()", launches,
           dict(flash_fwd=n_layers, flash_bwd_dq=n_layers if bwd else 0,
                flash_bwd_dkv=n_layers if bwd else 0))
    g0 = [p.grad for p in params]
    for p in params:
        p.grad = None

    # the create_graph path: K1 forward, the dense forward's backward
    dev.cuda.reset_max_memory_allocated()
    zero_flash_launches()
    loss, _ = model(ids, labels=ids)
    expect("forward", kernel_launches(),
           dict(flash_fwd=n_layers, flash_bwd_dq=0, flash_bwd_dkv=0))
    g = pt.grad(loss, params, create_graph=True)
    expect("grad(create_graph=True)", kernel_launches(),
           dict(flash_fwd=n_layers, flash_bwd_dq=0, flash_bwd_dkv=0))
    for k, n in kernel_launches().items():
        launches[k] += n
    first_gap = rel_l2(g, g0)
    # each product differentiates g, whose graph reads the attention
    # output: that first-order term goes back through K1's node, K3/K4 as
    # routed; the dense forward's backward takes the rest
    zero_flash_launches()
    del g0
    hvp_ms = []

    def hvp(v):
        start, end = dev.Event(enable_timing=True), dev.Event(
            enable_timing=True)
        start.record()
        hv = pt.grad(sum((gi * vi).sum() for gi, vi in zip(g, v)), params,
                     retain_graph=True)
        end.record()
        end.synchronize()
        hvp_ms.append(start.elapsed_time(end))
        return hv

    v0 = unit_direction(params, 1)
    hv0 = hvp(v0)
    u = unit_direction(params, 2)
    hu = hvp(u)
    sym = abs(dot(u, hv0) - dot(v0, hu)) / math.sqrt(dot(hv0, hv0))
    del u, hu
    rayleigh, v, hv = [], v0, hv0
    for step in range(HVP_POWER_STEPS):
        if step:
            hv = hvp(v)
        rayleigh.append(dot(v, hv))
        log(f"hvp {name}: power step {step + 1}: Rayleigh quotient "
            f"{rayleigh[-1]:.6e}, |Hv| {math.sqrt(dot(hv, hv)):.6e}")
        norm = math.sqrt(dot(hv, hv))
        v = [x / norm for x in hv]
    per = n_layers * len(hvp_ms) if bwd else 0
    expect("the products", kernel_launches(),
           dict(flash_fwd=0, flash_bwd_dq=per, flash_bwd_dkv=per))
    for k, n in kernel_launches().items():
        launches[k] += n
    peak = dev.cuda.max_memory_allocated()
    finite = all(math.isfinite(x) for x in rayleigh + [
        float(loss0.detach()), float(loss.detach())])
    finite = finite and all(bool(torch.isfinite(x).all()) for x in hv0)
    del g, loss, hv, v
    gc.collect()

    # Hv with the dense backend forced: no kernel launch
    pt.set_flags({"FLAGS_flash_attention_backend": "xla"})
    try:
        zero_flash_launches()
        loss_d, _ = model(ids, labels=ids)
        g = pt.grad(loss_d, params, create_graph=True)
        hv_d = pt.grad(sum((gi * vi).sum() for gi, vi in zip(g, v0)),
                       params)
        expect("dense backend", kernel_launches(),
               dict(flash_fwd=0, flash_bwd_dq=0, flash_bwd_dkv=0))
    finally:
        pt.set_flags({"FLAGS_flash_attention_backend": "auto"})
    dense_gap = rel_l2(hv0, hv_d)
    finite = finite and math.isfinite(float(loss_d.detach()))
    del g, hv_d, hv0, v0
    log(f"hvp {name} [{CARD}]: loss {float(loss0.detach()):.6f} "
        f"({float(loss_d.detach()):.6f} dense); first order through "
        f"create_graph against loss.backward() rel L2 {first_gap:.3e} (tol "
        f"{HVP_FIRST_ORDER_RTOL}); Hv through K1 against the dense backend "
        f"rel L2 {dense_gap:.3e} (tol {HVP_DENSE_RTOL}); symmetry "
        f"{sym:.3e} (tol {HVP_SYMMETRY_TOL}); ms per HVP "
        + ", ".join(f"{t:.1f}" for t in hvp_ms)
        + f" (median {statistics.median(hvp_ms):.1f}); peak memory "
        f"{peak / 2**30:.2f} GiB (create_graph graph and products); "
        f"launches {launches}")
    if not finite:
        problems.append("a loss, a Rayleigh quotient or Hv is not finite")
    if not first_gap <= HVP_FIRST_ORDER_RTOL:
        problems.append(f"first order rel L2 {first_gap:.3e}")
    if not dense_gap <= HVP_DENSE_RTOL:
        problems.append(f"Hv against the dense backend rel L2 "
                        f"{dense_gap:.3e}")
    if not sym <= HVP_SYMMETRY_TOL:
        problems.append(f"symmetry {sym:.3e}")
    del model, params, ids
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        sys.exit(f"chip_smoke: phase 22 failed: {problems}")
    return launches


def phase_nan_checker():
    """amp.debugging's checker on the card: a NaN placed into one layer's
    activation raises in the forward and names the op; sqrt at zero
    raises in the backward, which the autograd engine runs on its own
    thread; with the checker off no dispatch mode is in and the same
    forward runs unscanned."""
    from torch.utils._python_dispatch import _get_current_dispatch_mode
    dbg = amp.debugging
    pt.seed(0)
    lin1 = pt.nn.Linear(256, 256, device="cuda")
    lin2 = pt.nn.Linear(256, 256, device="cuda")
    x = torch.randn(64, 256, device="cuda")
    poison = torch.ones(64, 256, device="cuda")
    poison[3, 7] = float("nan")

    def forward():
        return lin2(lin1(x) * poison)

    def backward():
        h = torch.relu(lin1(x)).detach().requires_grad_(True)
        torch.sqrt(h).sum().backward()

    caught = {}
    dbg.enable_tensor_checker(dbg.TensorCheckerConfig(enable=True))
    try:
        for label, fn in (("forward", forward), ("backward", backward)):
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError as e:
                caught[label] = str(e)
    finally:
        dbg.disable_tensor_checker()
    out = forward()
    off = _get_current_dispatch_mode() is None and bool(
        torch.isnan(out).any())
    checked_ms = dbg.check_layer_numerics(lambda: time_ms(
        lambda: lin2(lin1(x)), reps=10, warmup=2))()
    plain_ms = time_ms(lambda: lin2(lin1(x)), reps=10, warmup=2)
    log(f"nan checker [{CARD}]: forward: {caught.get('forward')}; "
        f"backward: {caught.get('backward')}; off: no mode, NaN passed "
        f"{off}; two Linear(256) on b64 {checked_ms:.3f} ms scanned, "
        f"{plain_ms:.3f} ms off")
    if "aten.mul" not in caught.get("forward", "") or \
            "NaN or Inf" not in caught.get("backward", "") or not off:
        sys.exit("chip_smoke: the NaN/Inf checker did not catch the forward "
                 "or the backward NaN on the card, or stayed on")


def _feature(name, **kw):
    """audio.features.<name>(**kw) built on the signal's device, applied."""
    def run(x):
        return getattr(pt.audio.features, name)(device=x.device, **kw)(x)
    run.__name__ = f"audio.features.{name}"
    return run


def _fp8_gemm(x, y, bias=None, **kw):
    """linalg.fp8_fp8_half_gemm_fused on e4m3 copies of float32 x and y;
    records the path the card's call took."""
    before = dict(pt.linalg.FP8_GEMM_PATHS)
    out = pt.linalg.fp8_fp8_half_gemm_fused(
        x.to(torch.float8_e4m3fn), y.to(torch.float8_e4m3fn), bias, **kw)
    if x.is_cuda:
        FP8_PATHS.append(next(k for k, n in pt.linalg.FP8_GEMM_PATHS.items()
                              if n > before[k]))
    return out


FP8_PATHS = []


def _sdpa(x, k, v):
    return PF.scaled_dot_product_attention(x, k, v, is_causal=True)


def _attn_vjp(q, k, v):
    return pt.autograd.vjp(lambda x: _sdpa(x, k, v), q)


def _attn_jvp(q, k, v):
    return pt.autograd.jvp(lambda x: _sdpa(x, k, v), q, torch.ones_like(q))


def _attn_jacobian(q, k, v):
    return pt.autograd.jacobian(lambda x: _sdpa(x, k, v).float().sum(-1), q)


def _attn_hessian(q, k, v):
    return pt.autograd.hessian(
        lambda x: _sdpa(x, k, v).float().pow(2).sum(), q)


def slice_op_specs():
    """(family, name, args, kwargs, how) of this slice's functions, in
    phase_new_ops' form, on inputs from numpy's default_rng(0)."""
    r = np.random.default_rng(0)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    real, sig = f(4, 6, 8), f(2, 4000)
    cplx = (f(4, 6, 8) + 1j * f(4, 6, 8)).astype(np.complex64)
    win = np.hanning(257)[:-1].astype(np.float32)
    specs = [("fft", "fft." + n, [x], kw, "value") for n, x, kw in [
        ("fft", cplx, {}), ("ifft", cplx, dict(norm="ortho")),
        ("rfft", real, dict(n=12)), ("irfft", cplx, {}), ("hfft", cplx, {}),
        ("ihfft", real, {}), ("fft2", cplx, {}), ("rfftn", real, {}),
        ("irfftn", cplx, {}), ("hfftn", cplx, {}), ("ihfft2", real, {}),
        ("fftshift", real, {})]]
    spec = pt.signal.stft(torch.as_tensor(sig), 256, 64,
                          window=torch.as_tensor(win)).numpy()
    specs += [("signal", "signal.frame", [sig], dict(frame_length=256,
                                                      hop_length=64), "value"),
              ("signal", "signal.overlap_add", [f(2, 256, 30)],
               dict(hop_length=64), "value"),
              ("signal", "signal.stft", [sig, 256, 64],
               dict(window=win), "value"),
              ("signal", "signal.istft", [spec, 256, 64],
               dict(window=win, length=4000), "value")]
    specs += [("audio", _feature("Spectrogram", n_fft=512), [sig], {},
               "value"),
              ("audio", _feature("MelSpectrogram", sr=16000, n_fft=512),
               [sig], {}, "value"),
              ("audio dB", _feature("LogMelSpectrogram", sr=16000,
                                    n_fft=512, top_db=80.0), [sig], {},
               "value"),
              ("audio dB", _feature("MFCC", sr=16000, n_mfcc=40,
                                    n_fft=512), [sig], {}, "value")]
    # 2-D sizes of 16s take cuBLASLt's fp8 product; the others, and a
    # batch, the float32 product of the upcast operands
    for x, y, kw in [
            (f(256, 512), f(512, 128), {}),
            (f(256, 512), f(128, 512), dict(bias=f(128), transpose_y=True,
                                            activation_type="gelu",
                                            scale=0.25)),
            (f(512, 64), f(512, 128), dict(transpose_x=True,
                                           activation_type="relu",
                                           output_dtype="bfloat16")),
            (f(100, 72), f(72, 40), {}),
            (f(3, 64, 64), f(3, 64, 32), {})]:
        bias = kw.pop("bias", None)
        fam = "fp8 gemm " + ("bf16" if kw.get("output_dtype") == "bfloat16"
                             else "fp16")
        specs.append((fam, _fp8_gemm, [x, y, bias], kw, "value"))
    q, kv = f(1, 256, 2, 64), f(1, 256, 2, 64)
    bf = lambda a: torch.as_tensor(a).to(torch.bfloat16)  # noqa: E731
    small = [bf(q[:, :16]), bf(kv[:, :16]), bf(kv[:, :16] * 0.5)]
    for fn, args in ((_attn_vjp, [bf(q), bf(kv), bf(kv * 0.5)]),
                     (_attn_jvp, [bf(q), bf(kv), bf(kv * 0.5)]),
                     (_attn_jacobian, small), (_attn_hessian, small)):
        specs.append(("autograd", fn, args, {}, "value"))
    return specs


def phase_slice_ops():
    """This slice's functions on the card against the CPU, the transforms
    of attention through sdpa's kernel branch (the backend forced to the
    kernels): K1 must launch."""
    FP8_PATHS.clear()
    zero_flash_launches()
    pt.set_flags({"FLAGS_flash_attention_backend": "pallas"})
    try:
        rows = phase_new_ops(slice_op_specs(), SLICE_TOLS,
                             label="the second-order slice's functions")
    finally:
        pt.set_flags({"FLAGS_flash_attention_backend": "auto"})
    launches = kernel_launches()
    fp8 = [r for r in rows if r[0].startswith("fp8 gemm")]
    log("fp8 gemm on the card: " + "; ".join(
        f"case {i} {kw}: {path}, error {err:.3e}"
        for i, ((_, _, kw, err), path) in enumerate(zip(fp8, FP8_PATHS))))
    log(f"autograd transforms through sdpa's kernel branch: launches "
        f"{launches}")
    if launches["flash_fwd"] == 0 or "scaled_mm" not in FP8_PATHS:
        sys.exit("chip_smoke: the transforms did not reach K1, or no fp8 "
                 "case took cuBLASLt's product")


def phase_device_api():
    """paddle_tpu_torch.device on the card: a product queued on a stream
    of its own under stream_guard, events recorded and waited on, the
    current stream set and restored, the memory counters."""
    D = pt.device
    x = torch.randn(2048, 2048, device="cuda")
    x @ x                                   # cuBLAS's set-up, off the clock
    D.synchronize()
    side = D.Stream()
    side.wait_stream(D.current_stream())
    start = D.Event(enable_timing=True)
    with D.stream_guard(side):
        start.record(side)
        y = x @ x
        done = side.record_event(D.Event(enable_timing=True))
    D.current_stream().wait_event(done)
    same = bool(torch.equal(y, x @ x))
    side.synchronize()
    prev = D.set_stream(side)
    switched = D.current_stream().stream == side.stream
    D.set_stream(prev)
    D.synchronize()
    mem = [D.cuda.memory_allocated(), D.cuda.max_memory_allocated(),
           D.cuda.memory_reserved(), D.cuda.max_memory_reserved()]
    log(f"device api [{CARD}]: a 2048^2 float32 product on a side stream "
        f"{start.elapsed_time(done):.3f} ms by its events, equal to the "
        f"default stream's {same}, set_stream {switched}, queries "
        f"{side.query()} {done.query()}; allocated/peak/reserved/peak "
        f"reserved {[f'{m / 2**30:.2f} GiB' for m in mem]}")
    if not (same and switched and side.query() and done.query()
            and 0 < mem[0] <= mem[1] <= mem[3] and mem[0] <= mem[2]):
        sys.exit("chip_smoke: paddle_tpu_torch.device misbehaves on the "
                 "card")


def phase_second_order():
    """Phase 22: Hessian-vector products on llama_1.3b, the NaN/Inf
    checker, the device API and the slice's functions on the card."""
    launches = phase_hvp()
    phase_nan_checker()
    phase_device_api()
    phase_slice_ops()
    return launches


# phase 23 (a): graph learning at ogbn-arxiv's size (Hu et al. 2020, OGB:
# 169,343 nodes, 1,166,243 directed edges made symmetric, 128 features, 40
# classes; its year split trains on 90,941 nodes), the graph drawn from
# seed(0) with numpy; OGB's arxiv baselines: 3 layers, hidden 256,
# BatchNorm1D, dropout 0.5, Adam at lr 0.01, float32
ARXIV = dict(nodes=169343, edges=1166243, features=128, classes=40,
             train=90941)
GRAPH = dict(layers=3, hidden=256, dropout=0.5, lr=0.01)
GRAPH_STEPS = 10
# mini-batch GraphSAGE: seeds a batch and the fanout of each hop
SAGE_SEEDS = 1024
SAGE_FANOUTS = (15, 10, 5)


def arxiv_graph(nodes, edges, features, classes, train, seed=0):
    """A random graph of `edges` undirected edges (no self loops, both
    directions stored: 2 x edges directed ones), node features N(0, 1),
    labels the argmax of the features times a random projection (a signal
    to fit), and a random training split; numpy from `seed`."""
    r = np.random.default_rng(seed)
    src = r.integers(0, nodes, edges)
    dst = (src + r.integers(1, nodes, edges)) % nodes
    x = r.standard_normal((nodes, features), dtype=np.float32)
    proj = r.standard_normal((features, classes), dtype=np.float32)
    labels = (x @ proj).argmax(1)
    train_idx = np.sort(r.permutation(nodes)[:train])
    return dict(src=np.concatenate([src, dst]), dst=np.concatenate([dst, src]),
                x=x, labels=labels, train_idx=train_idx, nodes=nodes)


def gcn_adjacency(src, dst, n):
    """The symmetric-normalised adjacency with self loops, D^-1/2 (A + I)
    D^-1/2, as CSR rows by destination: (crows, cols, values) in numpy, a
    duplicate edge counted twice."""
    loops = np.arange(n)
    rows = np.concatenate([dst, loops])
    cols = np.concatenate([src, loops])
    deg = np.bincount(rows, minlength=n).astype(np.float32)
    inv = deg ** -0.5
    order = np.argsort(rows, kind="stable")
    rows, cols = rows[order], cols[order]
    crows = np.concatenate([[0], np.cumsum(np.bincount(rows, minlength=n))])
    return crows, cols, (inv[rows] * inv[cols]).astype(np.float32)


def csc_graph(src, dst, n):
    """(row, colptr) of the graph stored by destination: the sources of
    node v's in-edges are row[colptr[v]:colptr[v + 1]]."""
    order = np.argsort(dst, kind="stable")
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    return src[order], colptr


def graph_sage(P, in_dim, hidden, classes, layers, dropout):
    """GraphSAGE-mean as OGB's arxiv baseline writes it (PyG's SAGEConv: a
    Linear of the neighbours' mean plus a bias-free Linear of the node
    itself), BatchNorm1D, ReLU and dropout between layers; the mean
    through geometric.send_u_recv. forward(x, blocks) takes each layer's
    (src, dst, destination count); the destinations are the first rows of
    that layer's input."""
    dims = [in_dim] + [hidden] * (layers - 1) + [classes]

    class GraphSAGE(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin_l = P.nn.LayerList([P.nn.Linear(a, b) for a, b in
                                         zip(dims, dims[1:])])
            self.lin_r = P.nn.LayerList([
                P.nn.Linear(a, b, bias_attr=False)
                for a, b in zip(dims, dims[1:])])
            self.norms = P.nn.LayerList([P.nn.BatchNorm1D(hidden)
                                         for _ in range(layers - 1)])

        def forward(self, x, blocks):
            for i, (src, dst, n) in enumerate(blocks):
                agg = P.geometric.send_u_recv(x, src, dst, reduce_op="mean",
                                              out_size=n)
                x = self.lin_l[i](agg) + self.lin_r[i](x[:n])
                if i < layers - 1:
                    x = P.nn.functional.relu(self.norms[i](x))
                    x = P.nn.functional.dropout(x, dropout,
                                                training=self.training)
            return x

    return GraphSAGE()


def gcn(P, in_dim, hidden, classes, layers, dropout):
    """GCN as OGB's arxiv baseline writes it (Kipf and Welling: A_hat X W
    + b), BatchNorm1D, ReLU and dropout between layers; A_hat X through
    sparse.matmul on the normalised CSR adjacency."""
    dims = [in_dim] + [hidden] * (layers - 1) + [classes]

    class GCN(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.lins = P.nn.LayerList([
                P.nn.Linear(a, b, bias_attr=False)
                for a, b in zip(dims, dims[1:])])
            self.biases = P.nn.ParameterList([
                self.create_parameter([b], is_bias=True) for b in dims[1:]])
            self.norms = P.nn.LayerList([P.nn.BatchNorm1D(hidden)
                                         for _ in range(layers - 1)])

        def forward(self, x, adj):
            for i, lin in enumerate(self.lins):
                x = P.sparse.matmul(adj, lin(x)) + self.biases[i]
                if i < layers - 1:
                    x = P.nn.functional.relu(self.norms[i](x))
                    x = P.nn.functional.dropout(x, dropout,
                                                training=self.training)
            return x

    return GCN()


def sample_blocks(P, row, colptr, seeds, fanouts):
    """A GraphSAGE mini-batch as PGL builds one: hop by hop from the seeds,
    sample_neighbors then reindex_graph (the hop's nodes first, then the
    new neighbours). Returns the layers' (src, dst, destination count),
    the outermost hop first, and the nodes of the last hop: each layer's
    destinations are the first rows of its input."""
    nodes, hops = seeds, []
    for k in fanouts:
        nbrs, cnt = P.geometric.sample_neighbors(row, colptr, nodes,
                                                 sample_size=k)
        src, dst, out_nodes = P.geometric.reindex_graph(nodes, nbrs, cnt)
        hops.append((src, dst, len(nodes)))
        nodes = out_nodes
    return hops[::-1], nodes


def graph_loss(P, logits, labels, train_idx):
    """Cross-entropy over the training nodes."""
    return P.nn.functional.cross_entropy(P.gather(logits, train_idx),
                                         P.gather(labels, train_idx))


# phase 23 (c): Mixtral-8x7B's MoE block (Jiang et al. 2024: d_model 4096,
# 8 SwiGLU experts of 14336, top-2) through incubate's MoELayer with a
# GShardGate, bf16, 4,096 tokens, forward and backward
MOE = dict(d_model=4096, ffn=14336, experts=8, top_k=2, tokens=4096)
MOE_CHECK_TOKENS = 512
# the bf16 block against a float32 copy of the same weights on the first
# MOE_CHECK_TOKENS tokens whose top-2 experts agree: relative L2
MOE_BF16_RTOL = 3e-2
# phase 23 (c)'s numbers, printed beside phase 26 (c)'s expert-parallel MoE
MOE_DENSE = {}


def swiglu_expert(P, d_model, ffn):
    """A Mixtral expert: down(silu(gate(x)) * up(x)), no biases."""
    class SwiGLU(P.nn.Layer):
        def __init__(self):
            super().__init__()
            self.gate_proj = P.nn.Linear(d_model, ffn, bias_attr=False)
            self.up_proj = P.nn.Linear(d_model, ffn, bias_attr=False)
            self.down_proj = P.nn.Linear(ffn, d_model, bias_attr=False)

        def forward(self, x):
            return self.down_proj(P.nn.functional.silu(self.gate_proj(x))
                                  * self.up_proj(x))

    return SwiGLU()


def moe_block(P, d_model, ffn, experts, top_k):
    """incubate's MoELayer of `experts` SwiGLU experts behind a GShardGate
    (its load-balancing loss on gate.loss)."""
    moe = P.incubate.distributed.models.moe
    return moe.MoELayer(d_model, [swiglu_expert(P, d_model, ffn)
                                  for _ in range(experts)],
                        gate=moe.GShardGate(d_model, experts, top_k=top_k),
                        top_k=top_k)


# phase 23 (a): float32 logits and loss of the first step on the card
# against the CPU's at full size (dropout off, BatchNorm on batch
# statistics): neighbour sums by atomic index-adds on the card against
# the CPU's sequential ones, and GEMMs in other orders, relative to the
# largest |logit|
GRAPH_CPU_RTOL = 1e-4
GRAPH_CLASSES = (("gathers", ("indexselect", "index_select", "gather",
                              "index_elementwise")),
                 ("scatter/index-add", ("indexfunc", "index_add", "scatter",
                                        "indexing_backward", "put_")),
                 ("GEMMs", ("gemm", "nvjet", "xmma", "cutlass", "sm90_",
                            "gemv")),
                 ("sorts", ("sort", "radix")),
                 ("elementwise", ("elementwise",)))
# (b) ASP: BERT-base pruned 2:4, decorated AdamW, 1 + 4 steps
ASP_STEPS = 4
ASP_EXCLUDED = ["nsp_head"]          # the 2-wide NSP classifier's groups pad
# (d) the slice's functions on the card against the CPU, of the largest
# |value| (at least 1): float32 closed forms and gathers as phase 21's;
# the sums of message passing and sparse products are atomic on the card
SLICE17_TOLS = {"distribution": NEW_OPS_RTOL, "sparse": NEW_OPS_RTOL,
                "geometric": NEW_OPS_RTOL, "incubate": NEW_OPS_RTOL}


def graph_class(name):
    low = name.lower()
    return next((cls for cls, keys in GRAPH_CLASSES
                 if any(k in low for k in keys)), None) or "other"


def graph_models(g, adj):
    """(name, builder(dropout), its graph argument, directed edges a layer
    reads) of phase 23's two models."""
    n = g["nodes"]
    src = torch.as_tensor(g["src"], device="cuda")
    dst = torch.as_tensor(g["dst"], device="cuda")
    w = dict(in_dim=ARXIV["features"], hidden=GRAPH["hidden"],
             classes=ARXIV["classes"], layers=GRAPH["layers"])
    return [("graphsage", lambda p: graph_sage(pt, dropout=p, **w),
             [(src, dst, n)] * GRAPH["layers"], len(g["src"])),
            ("gcn", lambda p: gcn(pt, dropout=p, **w), adj,
             adj.nnz())]


def graph_cpu_check(build, state, graph, x, y, idx, cpu_graph):
    """The first step's logits and loss with dropout off on the card and
    on the CPU, from the same weights: (logit error of the largest
    |logit|, loss relative error)."""
    outs = []
    for dev, gr in (("cuda", graph), ("cpu", cpu_graph)):
        pt.set_device(dev)
        try:
            model = build(0.0)
        finally:
            pt.set_device("cuda")
        model.set_state_dict({k: v.to(dev) for k, v in state.items()})
        with torch.no_grad():
            logits = model(x.to(dev), gr)
            loss = graph_loss(pt, logits, y.to(dev), idx.to(dev))
        outs.append((logits.cpu(), float(loss)))
        del model
    (lc, fc), (lh, fh) = outs
    return (float((lc - lh).abs().max() / lh.abs().max()),
            abs(fc - fh) / abs(fh))


def graph_minibatch(model, opt, g, x, y, row, colptr):
    """Two GraphSAGE mini-batches of SAGE_SEEDS seeds (fanouts
    SAGE_FANOUTS, sample_neighbors then reindex_graph on the host):
    (host ms to sample, device ms to step, losses, nodes and edges per
    batch); fails if the first hop breaks the sampler's contract."""
    rng = np.random.default_rng(1)
    host_ms, dev_ms, losses, sizes = [], [], [], []
    for b in range(2):
        seeds = torch.as_tensor(rng.choice(g["nodes"], SAGE_SEEDS,
                                           replace=False))
        t0 = time.perf_counter()
        blocks, nodes = sample_blocks(pt, row, colptr, seeds, SAGE_FANOUTS)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if b == 0:
            check_sampled_hop(row, colptr, seeds, g)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        cuda_blocks = [(s.cuda(), d.cuda(), n) for s, d, n in blocks]
        nodes_c, seeds_c = nodes.cuda(), seeds.cuda()
        start.record()
        logits = model(x[nodes_c], cuda_blocks)
        loss = pt.nn.functional.cross_entropy(logits, y[seeds_c])
        loss.backward()
        opt.step()
        opt.clear_grad()
        end.record()
        end.synchronize()
        dev_ms.append(start.elapsed_time(end))
        losses.append(float(loss.detach()))
        sizes.append((len(nodes), sum(len(s) for s, _, _ in blocks)))
    return host_ms, dev_ms, losses, sizes


def check_sampled_hop(row, colptr, seeds, g):
    """sample_neighbors' contract on the seeds' hop, with edge ids: each
    pick an in-edge of its seed (row[eid] the neighbour), no edge twice
    for a seed, min(deg, fanout) picks a seed; and sample_size -1 takes
    every in-edge."""
    k = SAGE_FANOUTS[0]
    eids = torch.arange(len(row))
    nbrs, cnt, picked = pt.geometric.sample_neighbors(
        row, colptr, seeds, sample_size=k, eids=eids, return_eids=True)
    cp, s = colptr.numpy(), seeds.numpy()
    deg = cp[s + 1] - cp[s]
    owner = np.repeat(s, cnt.numpy())
    e = picked.numpy()
    ok = (np.array_equal(cnt.numpy(), np.minimum(deg, k))
          and np.array_equal(row.numpy()[e], nbrs.numpy())
          and bool(((e >= cp[owner]) & (e < cp[owner + 1])).all())
          and len(np.unique(owner * len(row) + e)) == len(e))
    _, all_cnt = pt.geometric.sample_neighbors(row, colptr, seeds)
    ok = ok and np.array_equal(all_cnt.numpy(), deg)
    if not ok:
        sys.exit("chip_smoke: sample_neighbors broke its contract on the "
                 "arxiv-sized graph")


def phase_graph():
    """(a) in a fresh process (graph_learning): traced late in this long
    process, the graph steps lost kernel records (337-346 of GraphSAGE's
    383 launch calls, by kernel_ms_by_class's census)."""
    code = ("import torch, chip_smoke as c\n"
            f"c.CARD = {CARD!r}\n"
            "torch.backends.cuda.matmul.allow_tf32 = False\n"
            "torch.backends.cudnn.allow_tf32 = False\n"
            "c.graph_learning()\n")
    gc.collect()
    torch.cuda.empty_cache()
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600,
                         cwd=os.path.dirname(os.path.abspath(__file__)))
    sys.stdout.write(out.stdout)
    sys.stdout.flush()
    if out.returncode:
        sys.exit(f"chip_smoke: phase 23 (a) failed:\n{out.stderr[-3000:]}")


def graph_learning():
    """GraphSAGE-mean and GCN at ogbn-arxiv's size, full batch, then
    mini-batch GraphSAGE."""
    t0 = time.perf_counter()
    g = arxiv_graph(**ARXIV)
    crows, cols, vals = gcn_adjacency(g["src"], g["dst"], g["nodes"])
    n = g["nodes"]
    adj = pt.sparse.sparse_csr_tensor(crows, cols, vals, [n, n],
                                      place="cuda")
    adj_cpu = pt.sparse.sparse_csr_tensor(crows, cols, vals, [n, n],
                                          place="cpu")
    x = torch.as_tensor(g["x"], device="cuda")
    y = torch.as_tensor(g["labels"], device="cuda")
    idx = torch.as_tensor(g["train_idx"], device="cuda")
    log(f"graph: ogbn-arxiv's size, {n} nodes, {len(g['src'])} directed "
        f"edges ({ARXIV['edges']} made symmetric), {ARXIV['features']} "
        f"features, {ARXIV['classes']} classes, {len(g['train_idx'])} "
        f"training nodes; GCN adjacency {adj.nnz()} entries with self "
        f"loops; built in {time.perf_counter() - t0:.2f} s")
    sage = None
    for name, build, graph, edges in graph_models(g, adj):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        pt.seed(0)
        model = build(GRAPH["dropout"])
        state = {k: v.detach().clone() for k, v in
                 model.state_dict().items()}
        opt = pt.optimizer.Adam(GRAPH["lr"], parameters=model.parameters())

        def step(i):
            loss = graph_loss(pt, model(x, graph), y, idx)
            loss.backward()
            opt.step()
            opt.clear_grad()
            return loss.detach()

        losses, _, warm_s, dt = train_llama.time_steps(step, GRAPH_STEPS,
                                                       torch.device("cuda"))
        step_ms = dt / GRAPH_STEPS * 1e3
        peak = torch.cuda.max_memory_allocated()
        census = {}
        by_class = kernel_ms_by_class(lambda: step(0), graph_class,
                                      census=census)
        cpu_graph = ([(s.cpu(), d.cpu(), k) for s, d, k in graph]
                     if name == "graphsage" else adj_cpu)
        t1 = time.perf_counter()
        logit_err, loss_err = graph_cpu_check(build, state, graph, x, y,
                                              idx, cpu_graph)
        cpu_s = time.perf_counter() - t1
        edges_per_s = GRAPH["layers"] * edges / (step_ms / 1e3)
        lost = ("" if census["kernels"] >= census["launches"] else
                ": it lost kernels, its shares are not reliable")
        log(f"graph {name} [{CARD}]: {sum(p.numel() for p in model.parameters())}"
            f" params, float32, 1 + {GRAPH_STEPS} full-batch steps "
            f"(warm-up {warm_s:.2f} s): step {step_ms:.2f} ms, "
            f"{edges_per_s / 1e6:.1f} M edges/s ({GRAPH['layers']} layers x "
            f"{edges} edges a step), peak memory {peak / 2**30:.2f} GiB; "
            f"one traced step ({census['kernels']} kernel records of "
            f"{census['launches']} launch calls{lost}): "
            f"{class_line(by_class)}; busy "
            f"{sum(by_class.values()) / step_ms:.1%} of the timed steps' "
            f"mean; losses {[round(v, 6) for v in losses]}")
        log(f"graph {name}: first step against the CPU at full size "
            f"(dropout off): logits {logit_err:.3e} of the largest |logit|,"
            f" loss rel {loss_err:.3e} (tol {GRAPH_CPU_RTOL}); CPU "
            f"{cpu_s:.1f} s")
        if not all(math.isfinite(v) for v in losses):
            sys.exit(f"chip_smoke: a {name} loss is not finite")
        if not losses[1] < losses[0]:
            sys.exit(f"chip_smoke: {name}'s first update did not lower the "
                     "loss")
        if not (logit_err <= GRAPH_CPU_RTOL and loss_err <= GRAPH_CPU_RTOL):
            sys.exit(f"chip_smoke: {name}'s first step on the card "
                     "disagrees with the CPU")
        if name == "graphsage":
            sage = (model, opt)
        else:
            del model, opt
    row, colptr = (torch.as_tensor(a) for a in csc_graph(
        g["src"], g["dst"], n))
    host_ms, dev_ms, losses, sizes = graph_minibatch(*sage, g, x, y, row,
                                                     colptr)
    log(f"graph graphsage mini-batch [{CARD}]: {SAGE_SEEDS} seeds, fanouts "
        f"{list(SAGE_FANOUTS)}: (nodes, edges) {sizes}; host ms to sample "
        f"{[round(v, 2) for v in host_ms]} against device ms to step "
        f"{[round(v, 3) for v in dev_ms]}; losses "
        f"{[round(v, 6) for v in losses]}; sampler contract held")
    if not all(math.isfinite(v) for v in losses):
        sys.exit("chip_smoke: a mini-batch GraphSAGE loss is not finite")


def asp_weights(model):
    """{name: weight} of the layers prune_model(model) would mask."""
    out = {}
    for path, sub in model.named_sublayers():
        if isinstance(sub, (pt.nn.Linear, pt.nn.Conv2D)) and \
                path not in ASP_EXCLUDED:
            out[path + ".weight"] = sub.weight
    return out


def mask_ties(w, n=2, m=4):
    """Per group of m (along the last axis), whether its n-th and (n+1)-th
    largest |w| are equal: where two sorts may keep different entries."""
    a = w.detach().float().abs().reshape(-1, m).sort(1, descending=True)[0]
    return a[:, n - 1] == a[:, n]


def phase_asp_bert(decision, phase14_ms):
    """(b) BERT-base at bench.py's b32 s512 bf16, pruned 2:4 by
    asp.prune_model (the NSP head excluded), asp.decorate around
    TrainStep's AdamW, 1 + ASP_STEPS steps; returns the flash launches."""
    asp = pt.incubate.asp
    gc.collect()
    torch.cuda.empty_cache()
    cfg, batch, seq, _, dtype = train_bert.bench_config("cuda")
    n_layers = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    train = train_bert.TrainStep(cfg, batch, seq, dtype, "cuda")
    before = {k: w.detach().cpu() for k, w in
              asp_weights(train.model).items()}
    t0 = time.perf_counter()
    asp.set_excluded_layers(ASP_EXCLUDED)
    try:
        densities = asp.prune_model(train.model, n=2, m=4)
    finally:
        asp.reset_excluded_layers()
    torch.cuda.synchronize()
    prune_ms = (time.perf_counter() - t0) * 1e3
    train.opt = asp.decorate(train.opt)
    params = dict(train.model.named_parameters())
    masks = {k: p._asp_mask for k, p in params.items()
             if getattr(p, "_asp_mask", None) is not None}
    # groups whose card mask differs from the CPU's; of those, the ones
    # without a tie at the boundary, where the two must agree
    groups = mism = ties = untied = 0
    for k, w in before.items():
        cpu = asp.create_mask(w).reshape(-1, 4)
        card = masks[k].cpu().reshape(-1, 4)
        tie = mask_ties(w)
        differ = (cpu != card).any(1)
        groups += cpu.shape[0]
        mism += int(differ.sum())
        ties += int(tie.sum())
        untied += int((differ & ~tie).sum())
    del before
    zero_flash_launches()                      # the path starts here
    losses, per_step, warm_s, dt = train_llama.time_steps(
        train.step, ASP_STEPS, torch.device("cuda"))
    launches = train_llama.launch_counts()     # the path ends here
    step_ms = dt / ASP_STEPS * 1e3
    peak = torch.cuda.max_memory_allocated()
    after = {k: (asp.calculate_density(params[k]),
                 asp.check_sparsity(params[k].detach()),
                 bool((params[k].detach()[masks[k] == 0] == 0).all()))
             for k in masks}
    unmasked_carry = [k for k, p in params.items()
                      if ("embeddings" in k or "norm" in k)
                      and hasattr(p, "_asp_mask")]
    log(f"asp bert_base 2:4 [{CARD}]: {len(densities)} layers pruned "
        f"({sum(m.numel() for m in masks.values())} weights, NSP head "
        f"excluded) in {prune_ms:.1f} ms on the card; masks against the "
        f"CPU's for the same weights: {mism} of {groups} groups differ, "
        f"{untied} of them without a tie, {ties} groups tie at the "
        f"boundary; b{batch} s{seq} {dtype}, "
        f"1 + {ASP_STEPS} decorated AdamW steps: step {step_ms:.2f} ms "
        f"against phase 14's dense {phase14_ms:.2f} ms "
        f"({step_ms - phase14_ms:+.2f} ms), peak memory "
        f"{peak / 2**30:.2f} GiB; losses {losses}; launches per step "
        f"{per_step[-1]}")
    fwd = decision.fwd == "pallas"
    bwd = fwd and decision.bwd == "pallas"
    want = {"flash_fwd": n_layers if fwd else 0,
            "flash_bwd_dq": n_layers if bwd else 0,
            "flash_bwd_dkv": n_layers if bwd else 0}
    problems = []
    if not all(math.isfinite(v) for v in losses):
        problems.append("a loss is not finite")
    if any(s != want for s in per_step):
        problems.append(f"launches per step {per_step}, expected {want}")
    if untied:
        problems.append(f"{untied} mask groups without a tie differ from "
                        "the CPU's")
    if any(abs(d - 0.5) > 1e-6 or not ok or not zero
           for d, ok, zero in after.values()):
        problems.append("a pruned weight lost its 2:4 pattern")
    if any(abs(d - 0.5) > 1e-6 for d in densities.values()):
        problems.append("a pruned density is not 0.5")
    if unmasked_carry:
        problems.append(f"unpruned parameters carry masks: {unmasked_carry}")
    del train, masks, params
    gc.collect()
    torch.cuda.empty_cache()
    if problems:
        sys.exit(f"chip_smoke: phase 23 (b) failed: {problems}")
    return launches


def phase_moe():
    """(c) incubate's MoELayer at Mixtral-8x7B's block width with a
    GShardGate, bf16, MOE["tokens"] tokens, forward and backward."""
    gc.collect()
    torch.cuda.empty_cache()
    d, ffn, e, k, t = (MOE[key] for key in ("d_model", "ffn", "experts",
                                            "top_k", "tokens"))
    pt.seed(0)
    block = moe_block(pt, d, ffn, e, k).to(torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    # the input requires its gradient, as a block's inside a model does
    x = torch.randn(t, d, generator=gen, device="cuda",
                    dtype=torch.bfloat16, requires_grad=True)
    params = block.parameters()

    def fwd_bwd():
        out = block(x)
        (out.float().pow(2).mean() + block.gate.loss.float()).backward()
        for p in params + [x]:
            p.grad = None
        return out.detach()

    fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out = fwd_bwd()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    aux = float(block.gate.loss.detach())
    # three products per expert and the gate's, each once forward and
    # twice backward (dX and dW: x requires its gradient)
    executed = 3 * 2 * t * d * ffn * e * 3 + 3 * 2 * t * d * e
    useful = executed * k / e
    best = min(ms) / 1e3
    # the float32 twin on the first MOE_CHECK_TOKENS tokens
    c = MOE_CHECK_TOKENS
    with torch.no_grad():
        xc = x[:c].detach()
        half = block(xc).float()
        topi16 = torch.topk(block.gate(xc), k, -1).indices
        twin = copy.deepcopy(block).float()
        full = twin(xc.float())
        topi32 = torch.topk(twin.gate(xc.float()), k, -1).indices
        same = (topi16.sort(-1)[0] == topi32.sort(-1)[0]).all(-1)
        err = float((half[same] - full[same]).norm() / full[same].norm())
    del twin
    MOE_DENSE.update(ms=min(ms), useful_tflops=useful / best / 1e12,
                     peak_gib=peak / 2**30)
    finite = bool(torch.isfinite(out).all()) and math.isfinite(aux)
    log(f"moe mixtral-8x7b block [{CARD}]: d_model {d}, {e} SwiGLU experts "
        f"of {ffn}, top-{k}, GShardGate, bf16, {t} tokens, forward and "
        f"backward: ms {[round(v, 3) for v in ms]}, peak memory "
        f"{peak / 2**30:.2f} GiB; {executed / 1e12:.2f} TFLOP executed, "
        f"{useful / 1e12:.2f} useful (the dense form runs every expert on "
        f"every token: {e / k:.0f}x), {executed / best / 1e12:.1f} TFLOP/s "
        f"executed, {useful / best / 1e12:.1f} useful; aux loss {aux:.6f}; "
        f"bf16 against a float32 twin on the first {c} tokens: "
        f"{int(same.sum())} with the same top-{k} experts, rel L2 "
        f"{err:.3e} over them (tol {MOE_BF16_RTOL})")
    del block, x, out, params
    gc.collect()
    torch.cuda.empty_cache()
    if not finite or not err <= MOE_BF16_RTOL or int(same.sum()) < c // 2:
        sys.exit("chip_smoke: the MoE block is not finite or its bf16 "
                 "output disagrees with float32")


def _called(path, method=None, nparams=None, **mkw):
    """A spec function: pt.<path>(*args[:nparams]) then, with `method`,
    its method (or property) on the remaining args; sparse results
    densified."""
    def run(*args):
        fn = _resolve(path)
        if method is None:
            out = fn(*args)
        else:
            obj = fn(*args[:nparams])
            attr = getattr(obj, method)
            out = attr(*args[nparams:], **mkw) if callable(attr) else attr
        return out.to_dense() if hasattr(out, "to_dense") else out
    run.__name__ = path + (f".{method}" if method else "")
    return run


def _sparse_op(name, *extra, csr=False, **kw):
    """pt.sparse.<name> on a COO (or CSR) tensor built from (indices,
    values[, shape]) arrays, then any further array args; densified."""
    def run(idx, vals, *rest):
        sp = pt.sparse.sparse_coo_tensor(idx, vals, SPARSE_SHAPE)
        if csr:
            sp = sp.to_sparse_csr()
        out = getattr(pt.sparse, name)(sp, *rest, *extra, **kw)
        return out.to_dense() if hasattr(out, "to_dense") else out
    run.__name__ = f"sparse.{name}" + ("(csr)" if csr else "")
    return run


def _subm_conv(idx, feats, weight, bias):
    conv = pt.sparse.nn.SubmConv3D(3, 4, 3, padding=1, device=feats.device)
    conv.set_state_dict({"_conv.weight": weight, "_conv.bias": bias})
    sp = pt.sparse.sparse_coo_tensor(idx, feats, [2, 4, 4, 4, 3])
    out = conv(sp)
    return [out.indices(), out.values()]


def _optimizer_walk(wrapper):
    """A parameter through 6 SGD steps toward a target inside
    incubate.LookAhead or ModelAverage; returns its final value."""
    def run(w0, target):
        p = torch.nn.Parameter(w0.clone())
        sgd = pt.optimizer.SGD(0.1, parameters=[p])
        la = pt.incubate.LookAhead(sgd, alpha=0.4, k=3) if \
            wrapper == "LookAhead" else None
        ma = pt.incubate.ModelAverage(0.15, parameters=[p]) if la is None \
            else None
        for _ in range(6):
            ((p - target) ** 2).sum().backward()
            (la or sgd).step()
            sgd.clear_grad()
            if ma is not None:
                ma.step()
        if ma is None:
            return p.detach()
        with ma.apply():
            return p.detach().clone()
    run.__name__ = f"incubate.{wrapper}"
    return run


def _switch_gate(x, weight, bias):
    gate = pt.incubate.distributed.models.moe.SwitchGate(
        x.shape[-1], weight.shape[-1], device=x.device)
    gate.set_state_dict({"gate.weight": weight, "gate.bias": bias})
    gate.eval()
    return gate(x)


SPARSE_SHAPE = [6, 5]


def slice17_op_specs():
    """(family, name, args, kwargs, how) of the graph, sparsity, MoE and
    distribution slice's functions, in phase_new_ops' form, on inputs from
    numpy's default_rng(0)."""
    r = np.random.default_rng(0)
    f = lambda *s: r.standard_normal(s).astype(np.float32)  # noqa: E731
    pos = lambda *s: r.uniform(0.5, 2.5, s).astype(np.float32)  # noqa
    unit = lambda *s: r.uniform(0.1, 0.9, s).astype(np.float32)  # noqa
    specs = []
    add = lambda fam, fn, args, kw=None, how="value": specs.append(  # noqa
        (fam, fn, args, kw or {}, how))
    # distribution: log_prob, entropy, cdf/icdf, KL, and draws by support
    # and moments
    dist = [("Normal", [f(4), pos(4)], f(4), ["log_prob", "entropy", "cdf"]),
            ("Beta", [pos(4), pos(4)], unit(4), ["log_prob", "entropy"]),
            ("Gamma", [pos(4), pos(4)], pos(4), ["log_prob", "entropy"]),
            ("StudentT", [pos(4) + 2, f(4), pos(4)], f(4),
             ["log_prob", "entropy"]),
            ("Laplace", [f(4), pos(4)], unit(4), ["log_prob", "icdf"]),
            ("ContinuousBernoulli", [unit(4)], unit(4),
             ["log_prob", "entropy", "cdf"]),
            ("Binomial", [np.array([5.0, 8.0, 3.0, 9.0], np.float32),
                          unit(4)], np.float32([2, 8, 0, 4]),
             ["log_prob", "entropy"]),
            ("Poisson", [pos(4) * 2], np.float32([0, 2, 7, 1]),
             ["log_prob", "entropy"]),
            ("Categorical", [f(3, 5)], np.array([0, 4, 2]),
             ["log_prob", "entropy"]),
            ("Dirichlet", [pos(2, 3)], np.float32([[0.2, 0.3, 0.5],
                                                   [0.6, 0.1, 0.3]]),
             ["log_prob", "entropy"])]
    for name, params, value, methods in dist:
        for m in methods:
            args = params + ([] if m == "entropy" else [value])
            add("distribution", _called("distribution." + name, m,
                                        len(params)), args)
    cov = np.float32([[2.0, 0.6, 0.1], [0.6, 1.0, 0.2], [0.1, 0.2, 0.5]])
    add("distribution", _called("distribution.MultivariateNormal",
                                "log_prob", 2), [f(3), cov, f(2, 3)])
    for name, p, q in [("Normal", [f(3), pos(3)], [f(3), pos(3)]),
                       ("Gamma", [pos(3), pos(3)], [pos(3), pos(3)]),
                       ("Beta", [pos(3), pos(3)], [pos(3), pos(3)]),
                       ("Dirichlet", [pos(3)], [pos(3)]),
                       ("Categorical", [f(2, 4)], [f(2, 4)])]:
        def kl(*a, name=name, k=len(p)):
            cls = getattr(pt.distribution, name)
            return pt.distribution.kl_divergence(cls(*a[:k]), cls(*a[k:]))
        kl.__name__ = f"distribution.kl({name})"
        add("distribution", kl, p + q)
    n = NEW_OPS_DRAWS
    for name, params, support, mean in [
            ("Normal", [1.0, 2.0], None, 1.0),
            ("Gamma", [3.0, 2.0], (0, 100), 1.5),
            ("Beta", [2.0, 3.0], (0, 1.01), 0.4),
            ("StudentT", [6.0, 1.0, 2.0], None, 1.0),
            ("Laplace", [1.0, 2.0], None, 1.0),
            ("Gumbel", [1.0, 2.0], None, 1.0 + 2 * 0.5772156649),
            ("Poisson", [4.0], (0, 100), 4.0),
            ("Binomial", [10.0, 0.4], (0, 10.01), 4.0),
            ("Bernoulli", [0.3], (0, 1.01), 0.3)]:
        def draw(*a, name=name):
            return getattr(pt.distribution, name)(*a).sample([n])
        draw.__name__ = f"distribution.{name}.sample"
        add("distribution", draw, [np.array(v, np.float32) for v in params],
            {}, ("random", support, mean))
    # sparse and sparse.nn
    idx = np.array([[0, 1, 1, 3, 2, 0, 5, 4, 1], [2, 0, 4, 3, 1, 4, 0, 2, 0]])
    vals = f(9)
    for name, extra in [("coalesce", []), ("sin", []), ("relu6", []),
                        ("sum", []), ("transpose", [[1, 0]]),
                        ("reshape", [[5, 6]])]:
        add("sparse", _sparse_op(name, *extra), [idx, vals])
    add("sparse", _sparse_op("matmul"), [idx, vals, f(5, 7)])
    add("sparse", _sparse_op("matmul", csr=True), [idx, vals, f(5, 7)])
    add("sparse", _sparse_op("mv"), [idx, vals, f(5)])
    add("sparse", _sparse_op("add", csr=True), [idx, vals, f(6, 5)])
    add("sparse", _sparse_op("multiply"), [idx, vals, f(6, 5)])
    add("sparse", lambda i, v, d: pt.sparse.mask_as(
        d, pt.sparse.sparse_coo_tensor(i, v, SPARSE_SHAPE)).to_dense(),
        [idx, vals, f(6, 5)])
    add("sparse", lambda i, v, a, b: pt.sparse.masked_matmul(
        a, b, pt.sparse.sparse_coo_tensor(i, v, SPARSE_SHAPE)).to_dense(),
        [idx, vals, f(6, 8), f(8, 5)])
    add("sparse", lambda i, v: pt.sparse.nn.functional.softmax(
        pt.sparse.sparse_coo_tensor(i, v, SPARSE_SHAPE)).to_dense(),
        [idx, vals])
    band = np.array([(i, j) for i in range(8) for j in range(8)
                     if abs(i - j) <= 2]).T
    add("sparse", lambda i, v, q, k_, v_: pt.sparse.nn.functional.attention(
        q, k_, v_, pt.sparse.sparse_coo_tensor(i, v, [8, 8])),
        [band, np.ones(band.shape[1], np.float32), f(8, 16), f(8, 16),
         f(8, 16)])
    sites = np.array([[0, 0, 0, 1, 1, 1, 0], [0, 1, 3, 0, 2, 3, 2],
                      [1, 2, 0, 1, 1, 2, 3], [0, 3, 1, 2, 0, 3, 3]])
    add("sparse", _subm_conv, [sites, f(7, 3), f(4, 3, 3, 3, 3) / 9,
                               f(4)])
    # geometric
    src = r.integers(0, 30, 200)
    dst = r.integers(0, 30, 200)
    x = f(30, 16)
    for op in ("sum", "mean", "max", "min"):
        add("geometric", "geometric.send_u_recv", [x, src, dst],
            dict(reduce_op=op, out_size=32))
    add("geometric", "geometric.send_ue_recv", [x, f(200, 16), src, dst],
        dict(message_op="mul", reduce_op="mean"))
    add("geometric", "geometric.send_uv", [x, x, src, dst],
        dict(message_op="sub"))
    add("geometric", "geometric.segment_max", [x, np.sort(dst[:30] // 3)])
    order = np.argsort(dst, kind="stable")
    colptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=30))])
    add("geometric", "geometric.sample_neighbors",
        [src[order], colptr, np.arange(0, 30, 3)])
    add("geometric", "geometric.reindex_graph",
        [np.array([5, 9, 2]), np.array([9, 7, 7, 3, 5, 11, 2]),
         np.array([2, 4, 1])])
    # incubate
    seg = np.array([0, 0, 2, 2, 3, 5, 5, 5])
    for pool in ("sum", "mean", "max", "min"):
        add("incubate", f"incubate.segment_{pool}", [f(8, 4), seg])
    add("incubate", "incubate.graph_send_recv", [x, src, dst],
        dict(pool_type="max", out_size=30))
    add("incubate", "incubate.softmax_mask_fuse",
        [f(2, 4, 8, 8), np.where(r.random((2, 1, 8, 8)) > 0.3, 0.0,
                                 -1e4).astype(np.float32)])
    add("incubate", "incubate.softmax_mask_fuse_upper_triangle",
        [f(2, 4, 8, 8)])
    add("incubate", "incubate.identity_loss", [f(5, 3)],
        dict(reduction="mean"))
    add("incubate", _optimizer_walk("LookAhead"), [f(6), f(6)])
    add("incubate", _optimizer_walk("ModelAverage"), [f(6), f(6)])
    add("incubate", _switch_gate, [f(16, 8), f(8, 4) / 3, f(4)])
    add("incubate", lambda w: pt.incubate.asp.create_mask(w), [f(32, 64)])
    return specs


def autotune_round_trips():
    """incubate.autotune.set_config as a dict, a JSON file and None, each
    read back through get_config and status; then tuning left off."""
    at = pt.incubate.autotune
    saved = at.get_config()
    results = []
    try:
        at.set_config({"kernel": {"enable": True, "tuning_range": [1, 3]}})
        results.append(at.status()["enabled"]
                       and at.get_config()["kernel"]["tuning_range"]
                       == [1, 3])
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "tune.json")
            with open(path, "w") as fh:
                json.dump({"kernel": {"enable": False},
                           "layout": {"enable": True}}, fh)
            at.set_config(path)
        results.append(not at.status()["enabled"]
                       and at.get_config()["layout"]["enable"])
        at.set_config(None)
        results.append(all(v["enable"] for v in at.get_config().values()))
    finally:
        at._config = saved
        pt.ops.autotune.disable_autotune()
    log(f"autotune round trips (dict, JSON file, None): {results}; "
        f"the flash kernels' compiled tiles {fa.TILE_CANDIDATES}")
    if not all(results):
        sys.exit("chip_smoke: incubate.autotune.set_config did not round "
                 "trip")


def phase_graph_sparsity(decision, phase14_ms):
    """Phase 23: graph learning at ogbn-arxiv's size, 2:4-pruned BERT-base
    through K1/K3/K4, the Mixtral MoE block, and the slice's functions on
    the card against the CPU. Returns the flash launches of (b), its only
    path through the kernels."""
    t0 = time.perf_counter()
    phase_graph()
    log(f"phase 23 (a): {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    launches = phase_asp_bert(decision, phase14_ms)
    log(f"phase 23 (b): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    phase_moe()
    log(f"phase 23 (c): {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    phase_new_ops(slice17_op_specs(), SLICE17_TOLS,
                  label="the graph, sparsity, MoE and distribution slice's "
                        "functions")
    autotune_round_trips()
    log(f"phase 23 (d): {time.perf_counter() - t1:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 24: the framework plumbing and the process layer of distributed
# ---------------------------------------------------------------------------

PLUMB_SEQ, PLUMB_NEW = 512, 32
# (b): the static.nn program on the card against the same program on the
# CPU, float32 with TF32 off, relative to the largest |value|
STATIC_NN_RTOL = 1e-4
STATIC_NN_SHAPE = (8, 3, 32, 32)
K1_KERNEL = "flash_fwd_kernel"
HUBCONF = '''\
"""A hub repository of one entry point: llama_1.3b (tools/train_llama.py's
llama_ladder()[0]) with random weights."""

import paddle_tpu_torch as pt
from paddle_tpu_torch.tools import train_llama


def llama_1p3b(seed=0, device="cuda"):
    """LlamaForCausalLM at llama_1.3b's widths and depth, bf16, weights
    drawn from pt.seed(seed)."""
    cfg = train_llama.llama_ladder()[0][1]
    pt.seed(seed)
    return pt.models.LlamaForCausalLM(cfg, device=device).eval()
'''
CPP_OP = r'''
#include <cstdint>
extern "C" void scale_add(const void** in, void** out,
                          const int64_t* const* shapes, const int* ndims,
                          int n) {
  const float* x = static_cast<const float*>(in[0]);
  const float* y = static_cast<const float*>(in[1]);
  float* o = static_cast<float*>(out[0]);
  int64_t m = 1;
  for (int d = 0; d < ndims[0]; ++d) m *= shapes[0][d];
  for (int64_t i = 0; i < m; ++i) o[i] = 2.0f * x[i] + y[i];
}
'''


def plumbing_batch(cfg):
    """The smallest batch from 1 whose prefill attention at PLUMB_SEQ the
    router sends to K1, and its decision."""
    heads = cfg.num_attention_heads
    d = cfg.hidden_size // heads
    for b in range(1, 9):
        dec = ar.route(b * heads, PLUMB_SEQ, PLUMB_SEQ, d, torch.bfloat16,
                       True, platform="cuda")
        if dec.fwd == "pallas":
            return b, dec
    sys.exit("chip_smoke: the router sends no batch of llama_1.3b's "
             f"prefill at s{PLUMB_SEQ} to K1")


def read_protobuf(path):
    """The events export_protobuf wrote: an 8-byte little-endian length,
    then the pickle."""
    import pickle
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        data = f.read()
    if n != len(data):
        sys.exit(f"chip_smoke: {path} says {n} bytes and holds {len(data)}")
    return pickle.loads(data)


def plumbing_serve(tmp):
    """(a) llama_1.3b from a local hub repository, saved and reloaded
    through static's inference model, its program run once and the model
    served greedily; returns K1's launches over the path (both generate
    calls and the program's run)."""
    repo = os.path.join(tmp, "hub")
    os.makedirs(repo)
    with open(os.path.join(repo, "hubconf.py"), "w") as f:
        f.write(HUBCONF)
    if pt.hub.list(repo) != ["llama_1p3b"]:
        sys.exit(f"chip_smoke: hub.list gave {pt.hub.list(repo)}")
    t0 = time.perf_counter()
    model = pt.hub.load(repo, "llama_1p3b")
    torch.cuda.synchronize()
    cfg = model.config
    n_layers = cfg.num_hidden_layers
    batch, dec = plumbing_batch(cfg)
    log(f"plumbing (a): hub.load llama_1.3b, {model.num_params()} params, "
        f"{n_layers} layers (full depth), hidden {cfg.hidden_size}, "
        f"{cfg.num_attention_heads} heads, bf16, in "
        f"{time.perf_counter() - t0:.2f} s; router at (bh "
        f"{batch * cfg.num_attention_heads}, s{PLUMB_SEQ}, d"
        f"{cfg.hidden_size // cfg.num_attention_heads}): fwd={dec.fwd} "
        f"[{dec.source}]")
    ids = torch.as_tensor(np.random.RandomState(0).randint(
        0, cfg.vocab_size, (batch, PLUMB_SEQ)), device="cuda")
    with torch.no_grad():                      # what the program must give
        eager = model(ids).float()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()                      # the main path starts here
    t0 = time.perf_counter()
    before = generation.generate(model, ids, max_new_tokens=PLUMB_NEW)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    first = fa.flash_fwd_launches
    prefix = os.path.join(tmp, "llama_1p3b")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.static.save_inference_model(
        prefix, [], [], layer=model,
        input_spec=[pt.static.InputSpec(list(ids.shape), "int64")])
    save_s = time.perf_counter() - t0
    nbytes = os.path.getsize(prefix + ".pdiparams")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    program, feeds, fetches = pt.static.load_inference_model(
        prefix, device="cuda")
    loaded = pt.hub.load(repo, "llama_1p3b", seed=1)   # other weights
    loaded.set_state_dict(fetches[0].state_dict())
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    before_run = fa.flash_fwd_launches
    t0 = time.perf_counter()
    logits = fetches[0](ids).float()
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    run_launches = fa.flash_fwd_launches - before_run
    finite = bool(torch.isfinite(logits).all())
    run_err = (float((logits - eager).abs().max() / eager.abs().max())
               if logits.shape == eager.shape else math.inf)
    del fetches, logits, eager
    prof = pt.profiler.Profiler()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with prof:
        after = generation.generate(loaded, ids, max_new_tokens=PLUMB_NEW)
        torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = fa.flash_fwd_launches           # the main path ends here
    peak = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    pb = pt.profiler.export_protobuf(prof, os.path.join(tmp, "gen.pb"))
    events = read_protobuf(pb)
    export_s = time.perf_counter() - t0
    k1_records = sum(e["device"] == "cuda" and K1_KERNEL in e["name"]
                     for e in events)
    log(f"plumbing (a) [{CARD}], while (e) and (f) run beside it: greedy "
        f"b{batch} s{PLUMB_SEQ} +{PLUMB_NEW} {first_s:.2f} s (the first "
        f"call); save_inference_model with the program {save_s:.2f} s "
        f"({nbytes} bytes of params), load_inference_model + set_state_dict "
        f"{load_s:.2f} s, the loaded program's run {run_s:.2f} s (logits "
        f"against the forward before saving: max err / max|logit| "
        f"{run_err:.3e}, tol {PREDICTOR_LOGITS_RTOL}), generate under the "
        f"profiler {gen_s:.2f} s; K1 launches {first}, {run_launches} and "
        f"{launches - first - run_launches}; export_protobuf and read back "
        f"{export_s:.2f} s, {os.path.getsize(pb)} bytes, {len(events)} "
        f"events, {k1_records} K1 kernel records; peak "
        f"memory {peak / 2**30:.2f} GiB")
    problems = []
    if not torch.equal(before, after):
        problems.append("the reloaded model's greedy tokens differ from the "
                        "model's before saving")
    if program.state_dict() or feeds:
        problems.append("load_inference_model's layer form returned a "
                        "non-empty program")
    if not finite or not run_err <= PREDICTOR_LOGITS_RTOL:
        problems.append(f"the loaded program's logits (finite: {finite}) "
                        f"are {run_err:.3e} of max|logit| from the forward "
                        "before saving")
    if run_launches != n_layers:
        problems.append(f"the loaded program's run launched {run_launches} "
                        f"K1, expected {n_layers}")
    for n in (first, launches - first - run_launches):
        if n < n_layers:
            problems.append(f"{n} K1 launches in a prefill of {n_layers} "
                            "layers")
    if not k1_records:
        problems.append(f"no {K1_KERNEL} record among the exported events")
    if problems:
        sys.exit(f"chip_smoke: plumbing (a): {problems}")
    del loaded
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def static_net(static, x):
    """The (b) program: conv2d, batch_norm, fc, layer_norm."""
    h = static.nn.conv2d(x, 16, 3, padding=1, act="relu")
    h = static.nn.batch_norm(h)
    h = static.nn.fc(h, 64, activation="relu")
    return static.nn.layer_norm(h, begin_norm_axis=1)


def run_static(program, x):
    with pt.utils.unique_name.guard(), pt.static.program_guard(program):
        return static_net(pt.static, x)


@torch.no_grad()
def plumbing_static(tmp):
    """(b) one static.nn program built on the CPU and on the card, the
    registry carried over by name; static.save/load; control flow."""
    st = pt.static
    x = np.random.RandomState(1).standard_normal(STATIC_NN_SHAPE).astype(
        np.float32)
    cpu, card = st.Program(), st.Program()
    run_static(cpu, torch.from_numpy(x))
    run_static(card, torch.from_numpy(x).cuda())
    card.set_state_dict(cpu.state_dict())
    want = run_static(cpu, torch.from_numpy(x))
    got = run_static(card, torch.from_numpy(x).cuda())
    gap = float((got.cpu() - want).abs().max() / want.abs().max())
    devices = {str(p.device) for p in card.state_dict().values()}
    prefix = os.path.join(tmp, "static_net")
    st.save(card, prefix)
    fresh = st.Program()
    with pt.utils.unique_name.guard(), pt.static.program_guard(fresh):
        pt.seed(5)
        static_net(pt.static, torch.from_numpy(x).cuda())
    st.load(fresh, prefix)
    same = all(torch.equal(fresh.state_dict()[k], v)
               for k, v in card.state_dict().items())
    # control flow on CUDA tensors
    v = torch.from_numpy(x[0, 0, 0]).cuda()
    c = st.cond(v.sum() > 0, lambda: v * 2, lambda: v - 1)
    c_want = v * 2 if float(v.sum()) > 0 else v - 1
    i, s = st.while_loop(lambda i, s: i < 10, lambda i, s: [i + 1, s + i],
                         [torch.tensor(0, device="cuda"),
                          torch.tensor(0, device="cuda")])
    xs = torch.from_numpy(x[0, 0, :5]).cuda()
    carry, ys = st.scan(lambda c, e: (c + e, c * e),
                        torch.zeros(x.shape[-1], device="cuda"), xs)
    carry_cpu, ys_cpu = st.scan(lambda c, e: (c + e, c * e),
                                torch.zeros(x.shape[-1]), xs.cpu())
    flow_ok = (torch.equal(c, c_want) and (int(i), int(s)) == (10, 45)
               and torch.equal(carry.cpu(), carry_cpu)
               and torch.equal(ys.cpu(), ys_cpu)
               and {t.device.type for t in (c, i, s, carry, ys)} == {"cuda"})
    log(f"plumbing (b) [{CARD}]: static.nn program ({len(card.state_dict())} "
        f"tensors on {sorted(devices)}) out {tuple(got.shape)}, card against "
        f"CPU {gap:.3e} of max |out| (tolerance {STATIC_NN_RTOL:g}); "
        f"static.save/load round trip {'equal' if same else 'DIFFERS'}; "
        f"cond/while_loop/scan on cuda {'right' if flow_ok else 'WRONG'}")
    if not (gap <= STATIC_NN_RTOL and devices == {"cuda:0"} and same
            and flow_ok and torch.isfinite(got).all()):
        sys.exit("chip_smoke: plumbing (b) failed")


def plumbing_cpp_extension(tmp):
    """(c) cpp_extension.load with g++ on this machine, the op called on
    CUDA tensors."""
    src = os.path.join(tmp, "scale_add.cc")
    with open(src, "w") as f:
        f.write(CPP_OP)
    t0 = time.perf_counter()
    lib = pt.utils.cpp_extension.load("scale_add", [src],
                                      build_directory=os.path.join(tmp, "ext"))
    build_s = time.perf_counter() - t0
    op = lib.op("scale_add")
    x = torch.arange(12, dtype=torch.float32, device="cuda").reshape(3, 4)
    y = torch.full((3, 4), 0.5, device="cuda")
    out = op(x, y)
    ok = out.device.type == "cuda" and torch.equal(out, 2 * x + y)
    log(f"plumbing (c): cpp_extension.load built scale_add with g++ in "
        f"{build_s:.2f} s; result on {out.device}, "
        f"{'equal to 2x + y' if ok else 'WRONG'}")
    if not ok:
        sys.exit("chip_smoke: plumbing (c) failed")


def plumbing_info():
    """(d) utils.run_check, version and sysconfig on the card."""
    import contextlib
    import io as _io
    buf = _io.StringIO()
    with contextlib.redirect_stdout(buf):
        pt.utils.run_check()
        pt.version.show()
    text = buf.getvalue()
    for line in text.splitlines():
        log(f"plumbing (d): {line}")
    log(f"plumbing (d): version.cuda() {pt.version.cuda()}, cudnn() "
        f"{pt.version.cudnn()}, nccl() {pt.version.nccl()}, tpu() "
        f"{pt.version.tpu()}; sysconfig include {pt.sysconfig.get_include()}"
        f", lib {pt.sysconfig.get_lib()}")
    from paddle_tpu_torch.distributed import parallel_env
    try:
        parallel_env._check_backend("nccl", torch.cuda.device_count() + 1)
        refused = False
    except RuntimeError:
        refused = True
    if ("checksum 2097152" not in text or torch.cuda.get_device_name(0)
            not in text or not refused):
        sys.exit("chip_smoke: plumbing (d) failed")


def free_port():
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def start_drill(tmp):
    """(e) two ranks on the one card under the port's launcher, gloo."""
    out = os.path.join(tmp, "drill")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc_per_node", "2", "--master", f"127.0.0.1:{free_port()}",
           "--backend", "gloo", "--max_restart", "0", "--log_dir", out,
           "paddle_tpu_torch/tools/collective_drill.py",
           os.path.join(out, "result"), "--device", "cuda"]
    return out, subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def finish_drill(out, proc, t0):
    from paddle_tpu_torch.tools import collective_drill
    text, _ = proc.communicate(timeout=300)
    logs = "".join(Path(out, f"worker.{r}.log").read_text()[-1500:]
                   for r in range(2) if Path(out, f"worker.{r}.log").exists())
    if proc.returncode != 0:
        sys.exit(f"chip_smoke: the two-rank launch exited "
                 f"{proc.returncode}: {text[-1500:]}{logs}")
    problems = []
    for r in range(2):
        with open(os.path.join(out, f"result.rank{r}")) as f:
            got = json.load(f)
        want = collective_drill.expected(r)
        wrong = {k: (got.get(k), v) for k, v in want.items()
                 if got.get(k) != v}
        if wrong or got["devices"] != ["cuda:0"] or got["world"] != 2:
            problems.append((r, wrong, got["devices"], got["world"]))
    log(f"plumbing (e): launch --nproc_per_node 2 --backend gloo, both ranks "
        f"exit 0 in {time.perf_counter() - t0:.1f} s, tensors on cuda:0, "
        f"drill values {'as the reference drill' if not problems else problems}")
    if problems:
        sys.exit(f"chip_smoke: plumbing (e): {problems}")


def start_loadgen_dashboard():
    """(f) the loadgen CLI with --dashboard on the card."""
    cmd = [sys.executable, "-m", "paddle_tpu_torch.tools.loadgen",
           "--scenario", "chat", "--seed", "0", "--dashboard"]
    return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finish_loadgen_dashboard(proc, t0):
    out, err = proc.communicate(timeout=300)
    board = err[err.find("== observability dashboard =="):]
    rows = [line for line in board.splitlines()[2:] if line.strip()]
    log(f"plumbing (f): loadgen --scenario chat --seed 0 --dashboard exit "
        f"{proc.returncode} in {time.perf_counter() - t0:.1f} s; dashboard "
        f"{len(rows)} rows: {rows[:3]}")
    if proc.returncode != 0 or "== observability dashboard ==" not in err \
            or not rows:
        sys.exit(f"chip_smoke: plumbing (f) failed: {err[-1500:]}")
    json.loads(out[:out.rfind("}") + 1])     # the report is JSON


def phase_plumbing():
    """Phase 24; returns K1's launches on (a)'s path. (e) and (f) are
    subprocesses that run beside (a)-(d)."""
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        drill = start_drill(tmp)
        board = start_loadgen_dashboard()
        launches = plumbing_serve(tmp)
        log(f"phase 24 (a): {time.perf_counter() - t0:.1f} s")
        t1 = time.perf_counter()
        plumbing_static(tmp)
        plumbing_cpp_extension(tmp)
        plumbing_info()
        log(f"phase 24 (b)-(d): {time.perf_counter() - t1:.1f} s")
        finish_drill(*drill, t0)
        finish_loadgen_dashboard(board, t0)
    return launches


# -- phase 25: distributed training ----------------------------------------

# (a): 1 + DIST_STEPS AdamW steps through dist.to_static; the batch is b8
# if the reckoning of the step's memory (dist_reckoning) leaves at least
# DIST_FREE_GIB of the card free, else b4
DIST_STEPS = 3
DIST_LR = 3e-4
DIST_FREE_GIB = 10
# the first loss against the plain model's model(ids, labels=ids) on the
# same weights and batch, bf16, relative
DIST_PLAIN_LOSS_RTOL = 1e-3
# (c): a user-written decoder at llama_1.3b's width through fleet
FLEET = dict(layers=4, hidden=2048, heads=16, ffn=5504, vocab=32000,
             batch=8, seq=2048, micro=4, mp=2, pp=2)
# the pipeline's losses against the same layers run unwrapped with
# micro-batch accumulation, relative
FLEET_LOSS_RTOL = 1e-3
# (d): one DataParallel(resnet50) step at this batch, float32
DP_BATCH = 64


def dist_activation_bytes(cfg, batch, seq):
    """The reckoning of what autograd keeps for a Llama step without remat,
    bf16: per token and layer eleven hidden-wide tensors (the norms' inputs
    and outputs, q, k, v before and after the rotary, the attention output,
    the residual sum) and four of the FFN's width (gate, up, silu(gate),
    their product); then the loss's bf16 logits and its two float32 copies
    (the log_softmax's input and output)."""
    h, f = cfg.hidden_size, cfg.intermediate_size
    per_token = cfg.num_hidden_layers * 2 * (11 * h + 4 * f) + \
        cfg.vocab_size * (2 + 4 + 4)
    return batch * seq * per_token


def dist_reckoning(cfg, n_params, seq):
    """(batch, bytes needed, bytes left): the model, the trainer's copy, its
    two AdamW moments and the gradients, all bf16, beside the activations
    of the largest batch of 8 and 4 that leaves DIST_FREE_GIB free."""
    total = torch.cuda.get_device_properties(0).total_memory
    state = 2 * n_params * 5
    for batch in (8, 4):
        need = state + dist_activation_bytes(cfg, batch, seq)
        if total - need >= DIST_FREE_GIB * 2**30:
            break
    return batch, need, total - need


def dist_train(model, batch, strategy, rules):
    """1 + DIST_STEPS steps of `model` through dist.to_static; returns the
    trainer, the losses, each timed step's launches, the timed seconds,
    the whole run's launches and the peak memory."""
    opt = optimizer.AdamW(DIST_LR, parameters=model.parameters())
    dm = pt.distributed.to_static(model, [batch], None, opt, strategy,
                                  rules=rules)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_flash_launches()
    losses, per_step, _, secs = train_llama.time_steps(
        lambda n: dm(batch), DIST_STEPS, torch.device("cuda"))
    launches = kernel_launches()
    return (dm.engine._trainer, losses, per_step, secs, launches,
            torch.cuda.max_memory_allocated())


def dist_tensors(trainer):
    """name -> tensor of the trainer's parameters and AdamW moments."""
    out = dict(trainer.params)
    for n, st in trainer.opt_state.items():
        for k, v in st.items():
            out[f"{n}.{k}"] = v
    return out


def dist_check_chunks(trainer, dp_like):
    """Every parameter's and state's chunk map is the one its ZeRO spec
    gives: stage 3 partitions parameters, stage >= 1 states. Returns how
    many tensors were checked."""
    from paddle_tpu_torch.distributed.placement import (chunk_map,
                                                        spec_to_placements)
    mesh, n = trainer.mesh, 0
    for name, p in trainer.params.items():
        zero = trainer._zero_specs[name]
        if not dp_like and "sharding" not in zero and p.ndim:
            sys.exit(f"chip_smoke: {name} has no ZeRO axis ({zero})")
        pspec = zero if trainer.sharding_stage >= 3 else p.partition_spec
        for t, spec in [(p, pspec)] + [(v, zero) for v in
                                        trainer.opt_state[name].values()]:
            want = chunk_map(mesh, spec_to_placements(spec, mesh, t.ndim),
                             t.shape)
            if chunk_map(mesh, t.placements, t.shape) != want:
                sys.exit(f"chip_smoke: {name}'s chunk map is not its spec "
                         f"{spec}'s")
            n += 1
    return n


def dist_layout(tensors, mesh, rules):
    """Empty tensors like `tensors`, laid out on `mesh` by `rules` (a
    moment by its parameter's name), or unmarked with mesh None."""
    from paddle_tpu_torch.parallel import spmd
    out = {}
    for key, src in tensors.items():
        empty = torch.empty_like(src)
        if mesh is None:
            out[key] = empty
            continue
        pname = re.sub(r"\.moment[12]$", "", key)
        out[key] = spmd.shard_params_by_rules({pname: empty}, mesh,
                                              rules)[pname]
    return out


def dist_checkpoint(tensors):
    """(b): save the 2x2 layout's tensors, load them onto three others."""
    from paddle_tpu_torch.distributed import checkpoint as ckpt
    from paddle_tpu_torch.parallel import spmd
    nbytes = sum(t.numel() * t.element_size() for t in tensors.values())
    with tempfile.TemporaryDirectory() as tmp:
        free = shutil.disk_usage(tmp).free
        log(f"dist (b): {len(tensors)} tensors, {nbytes / 1e9:.3f} GB; "
            f"{free / 1e9:.1f} GB free under {tmp}")
        if free < 2 * nbytes:
            tensors = {k: v for k, v in tensors.items()
                       if not re.search(r"\.moment[12]$", k)}
            nbytes = sum(t.numel() * t.element_size()
                         for t in tensors.values())
            log(f"dist (b): less than twice that free: parameters only, "
                f"{nbytes / 1e9:.3f} GB")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckpt.save_state_dict(tensors, tmp)
        save_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "metadata.json")) as f:
            meta = json.load(f)
        chunks = [c for a in meta["arrays"].values() for c in a["chunks"]]
        files = sorted(x for x in os.listdir(tmp) if x.endswith(".npy"))
        data = sum(np.load(os.path.join(tmp, x), mmap_mode="r").nbytes
                   for x in files)
        if len(files) != len(chunks) or data != nbytes:
            sys.exit(f"chip_smoke: {len(files)} files of {data} bytes for "
                     f"{len(chunks)} distinct chunks of {nbytes} bytes")
        log(f"dist (b): save {save_s:.2f} s ({nbytes / save_s / 1e9:.2f} "
            f"GB/s), {len(files)} files, each distinct chunk once")
        layouts = [("dp-only", spmd.create_mesh(), spmd.DP_ONLY_RULES),
                   ("mp=4", spmd.create_mesh(mp=4),
                    spmd.LLAMA_SHARDING_RULES),
                   ("plain", None, None)]
        for name, mesh, rules in layouts:
            dst = dist_layout(tensors, mesh, rules)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.load_state_dict(dst, tmp)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
            stats = dict(ckpt.last_load_stats)
            bad = [k for k, v in dst.items() if not torch.equal(v,
                                                                tensors[k])]
            if bad:
                sys.exit(f"chip_smoke: load onto {name}: {len(bad)} tensors "
                         f"differ, first {bad[0]}")
            if stats != {"files": len(files), "bytes": nbytes}:
                sys.exit(f"chip_smoke: load onto {name} read {stats}, the "
                         f"overlapping chunks are {len(files)} files of "
                         f"{nbytes} bytes")
            log(f"dist (b): load onto {name} {secs:.2f} s "
                f"({nbytes / secs / 1e9:.2f} GB/s), bitwise equal, read "
                f"{stats['files']} files / {stats['bytes']} bytes: each "
                "overlapping chunk once")
            del dst
            torch.cuda.empty_cache()
        key = next(iter(tensors))
        victim = meta["arrays"][key]["chunks"][0]["file"]
        with open(os.path.join(tmp, victim), "r+b") as f:
            f.seek(-1, os.SEEK_END)
            last = f.read(1)
            f.seek(-1, os.SEEK_END)
            f.write(bytes([last[0] ^ 0xFF]))
        try:
            ckpt.load_state_dict({key: torch.empty_like(tensors[key])}, tmp)
            sys.exit(f"chip_smoke: a corrupt chunk {victim} loaded")
        except ckpt.CheckpointCorruptionError as e:
            if e.file != victim:
                sys.exit(f"chip_smoke: corruption named {e.file}, not "
                         f"{victim}")
            log(f"dist (b): corrupt chunk refused: {e}")


class FleetEmbed(pt.nn.Layer):
    """ids (b, s) -> sequence-parallel activations (s, b, h)."""

    def __init__(self, vocab, hidden):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
        self.emb = mpu.VocabParallelEmbedding(vocab, hidden)

    def forward(self, ids):
        from paddle_tpu_torch.distributed.fleet.utils import \
            sequence_parallel_utils as spu
        return spu.scatter(self.emb(ids).transpose(0, 1))


class FleetBlock(pt.nn.Layer):
    """A pre-norm decoder block written from fleet's layers: attention's
    projections sequence-parallel, the MLP tensor-parallel, causal
    attention through F.scaled_dot_product_attention."""

    def __init__(self, hidden, heads, ffn):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
        from paddle_tpu_torch.distributed.fleet.utils import \
            sequence_parallel_utils as spu
        self.heads = heads
        self.norm1 = pt.nn.RMSNorm(hidden)
        self.norm2 = pt.nn.RMSNorm(hidden)
        for p in (self.norm1.weight, self.norm2.weight):
            spu.mark_as_sequence_parallel_parameter(p)
        self.qkv = spu.ColumnSequenceParallelLinear(hidden, 3 * hidden,
                                                    has_bias=False)
        self.proj = spu.RowSequenceParallelLinear(hidden, hidden,
                                                  has_bias=False)
        self.up = mpu.ColumnParallelLinear(hidden, ffn, has_bias=False,
                                           gather_output=False)
        self.down = mpu.RowParallelLinear(ffn, hidden, has_bias=False,
                                          input_is_parallel=True)

    def forward(self, x):
        from paddle_tpu_torch.distributed.fleet.utils import \
            sequence_parallel_utils as spu
        s, b, h = x.shape
        qkv = self.qkv(self.norm1(x)).reshape(s, b, 3, self.heads,
                                              h // self.heads)
        q, k, v = qkv.permute(2, 1, 0, 3, 4).unbind(0)      # (b, s, n, d)
        a = PF.scaled_dot_product_attention(q, k, v, is_causal=True)
        x = x + self.proj(a.transpose(0, 1).reshape(s, b, h))
        y = spu.all_gather(self.norm2(x))
        return x + spu.scatter(self.down(PF.silu(self.up(y))))


class FleetHead(pt.nn.Layer):
    def __init__(self, hidden, vocab):
        super().__init__()
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
        from paddle_tpu_torch.distributed.fleet.utils import \
            sequence_parallel_utils as spu
        self.norm = pt.nn.RMSNorm(hidden)
        spu.mark_as_sequence_parallel_parameter(self.norm.weight)
        self.out = mpu.ColumnParallelLinear(hidden, vocab, has_bias=False,
                                            gather_output=False)

    def forward(self, x):
        from paddle_tpu_torch.distributed.fleet.utils import \
            sequence_parallel_utils as spu
        return self.out(spu.all_gather(self.norm(x))).transpose(0, 1)


class FleetLoss:
    """Next-token ParallelCrossEntropy, averaged."""

    def __init__(self):
        from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
        self.ce = mpu.ParallelCrossEntropy()

    def __call__(self, logits, ids):
        return self.ce(logits[:, :-1], ids[:, 1:]).mean()


def fleet_pipeline(c):
    from paddle_tpu_torch.distributed.fleet import meta_parallel as mpu
    return mpu.PipelineLayer(
        [mpu.LayerDesc(FleetEmbed, c["vocab"], c["hidden"])]
        + [mpu.LayerDesc(FleetBlock, c["hidden"], c["heads"], c["ffn"])
           for _ in range(c["layers"])]
        + [mpu.LayerDesc(FleetHead, c["hidden"], c["vocab"])],
        num_stages=c["pp"], loss_fn=FleetLoss())


def dist_fleet():
    """(c): the decoder through fleet's PipelineParallel.train_batch and
    distributed_optimizer, against the same layers unwrapped with
    micro-batch accumulation. Returns the pipeline run's launches."""
    from paddle_tpu_torch.distributed import fleet
    c = FLEET
    st = fleet.DistributedStrategy()
    st.hybrid_configs.update(mp_degree=c["mp"], pp_degree=c["pp"])
    st.pipeline_configs["accumulate_steps"] = c["micro"]
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    try:
        d = c["hidden"] // c["heads"]
        micro = c["batch"] // c["micro"]
        dec = ar.route(micro * c["heads"], c["seq"], c["seq"], d,
                       torch.bfloat16, True, platform="cuda")
        pt.seed(0)
        pipe = fleet_pipeline(c).to(dtype=torch.bfloat16)
        plain = fleet_pipeline(c).to(dtype=torch.bfloat16)
        plain.set_state_dict(pipe.state_dict())
        n_params = sum(p.numel() for p in pipe.parameters())
        model = fleet.distributed_model(pipe)
        opt = fleet.distributed_optimizer(
            optimizer.AdamW(DIST_LR, parameters=pipe.parameters()))
        plain_opt = optimizer.AdamW(DIST_LR, parameters=plain.parameters())
        gen = torch.Generator(device="cuda").manual_seed(0)
        ids = torch.randint(0, c["vocab"], (c["batch"], c["seq"]),
                            generator=gen, device="cuda")
        log(f"dist (c): {type(model).__name__} over mp {c['mp']} x pp "
            f"{c['pp']} (mesh {hcg.mesh.shape}), {c['layers']} layers at "
            f"hidden {c['hidden']}, {n_params} params, b{c['batch']} "
            f"s{c['seq']} in {c['micro']} micro-batches; router at (bh "
            f"{micro * c['heads']}, s{c['seq']}, d{d}, bf16, causal): "
            f"fwd={dec.fwd} bwd={dec.bwd} [{dec.source}]")
        torch.cuda.synchronize()
        zero_flash_launches()
        losses, per_step, _, secs = train_llama.time_steps(
            lambda n: model.train_batch((ids, ids), opt), DIST_STEPS,
            torch.device("cuda"))
        launches = kernel_launches()
        want = []
        for _ in range(DIST_STEPS + 1):
            total = 0.0
            for x in ids.chunk(c["micro"]):
                loss = plain._loss_fn(plain(x), x)
                (loss / c["micro"]).backward()
                total = total + loss.detach()
            plain_opt.step()
            plain_opt.clear_grad()
            want.append(float(total / c["micro"]))
        gap = max(abs(a - b) / abs(b) for a, b in zip(losses, want))
        step_ms = secs / DIST_STEPS * 1e3
        log(f"dist (c): losses {losses}, unwrapped {want}, largest "
            f"relative gap {gap:.3e} (tol {FLEET_LOSS_RTOL:g}); step "
            f"{step_ms:.1f} ms, "
            f"{c['batch'] * c['seq'] / (secs / DIST_STEPS):.1f} tokens/s; "
            f"launches a step {per_step[-1]}")
        if not all(np.isfinite(losses)) or gap > FLEET_LOSS_RTOL:
            sys.exit("chip_smoke: the pipeline's losses are not the "
                     "unwrapped layers'")
        fwd = dec.fwd == "pallas"
        bwd = fwd and dec.bwd == "pallas"
        n = c["layers"] * c["micro"]
        want_launches = {"flash_fwd": n if fwd else 0,
                         "flash_bwd_dq": n if bwd else 0,
                         "flash_bwd_dkv": n if bwd else 0}
        for i, got in enumerate(per_step):
            if got != want_launches:
                sys.exit(f"chip_smoke: fleet step {i + 2} launched {got}, "
                         f"expected {want_launches}")
        return launches
    finally:
        fleet._hcg = None


def dist_data_parallel(tmp):
    """(d): one DataParallel(resnet50) step after convert_sync_batchnorm
    through group_sharded_parallel("p_g_os"), against the plain model's
    step; then save_group_sharded_model and a reload."""
    pt.seed(0)
    net = VM.resnet50(device="cuda")
    plain = copy.deepcopy(net)
    model = pt.DataParallel(pt.nn.SyncBatchNorm.convert_sync_batchnorm(net))
    model, sopt, _ = pt.distributed.group_sharded_parallel(
        model, optimizer.Momentum(0.1, 0.9, parameters=net.parameters()),
        "p_g_os")
    popt = optimizer.Momentum(0.1, 0.9, parameters=plain.parameters())
    rs = np.random.RandomState(0)
    x = torch.as_tensor(rs.randn(DP_BATCH, 3, 224, 224).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rs.randint(0, 1000, (DP_BATCH,)), device="cuda")
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        losses = []
        for m, o in ((model, sopt), (plain, popt)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = PF.cross_entropy(m(x), y)
            loss.backward()
            o.step()
            o.clear_grad()
            torch.cuda.synchronize()
            losses.append((float(loss.detach()), time.perf_counter() - t0))
    finally:
        torch.backends.cudnn.deterministic = deterministic
    same = all(torch.equal(a, b) for a, b in zip(
        model.state_dict().values(), plain.state_dict().values()))
    log(f"dist (d): DataParallel(SyncBatchNorm resnet50) b{DP_BATCH} "
        f"float32 loss {losses[0][0]!r} in {losses[0][1]:.3f} s, plain "
        f"{losses[1][0]!r} in {losses[1][1]:.3f} s; state after the step "
        f"equal: {same}")
    if losses[0][0] != losses[1][0] or not same:
        sys.exit("chip_smoke: the DataParallel step is not the plain "
                 "model's")
    pt.distributed.save_group_sharded_model(model, tmp, sopt)
    back = VM.resnet50(device="cuda")
    back.set_state_dict(pt.load(os.path.join(tmp, "model.pdparams")))
    bopt = optimizer.Momentum(0.1, 0.9, parameters=back.parameters())
    bopt.set_state_dict(pt.load(os.path.join(tmp, "model.pdopt")))
    ok = all(torch.equal(a, b) for a, b in zip(
        back.state_dict().values(), plain.state_dict().values()))
    ok = ok and all(torch.equal(bopt._accumulators[id(q)][k], v)
                    for p, q in zip(net.parameters(), back.parameters())
                    for k, v in sopt._accumulators[id(p)].items())
    log(f"dist (d): save_group_sharded_model round trip bitwise: {ok}")
    if not ok:
        sys.exit("chip_smoke: save_group_sharded_model did not round-trip")


def phase_distributed():
    """Phase 25; returns each kernel's launches on its main path: (a)'s
    2x2 run and (c)'s pipeline."""
    gc.collect()
    torch.cuda.empty_cache()
    dist = pt.distributed
    from paddle_tpu_torch.parallel import spmd
    name, cfg, _, seq, *_ = train_llama.llama_ladder()[0]
    n_layers = cfg.num_hidden_layers
    t0 = time.perf_counter()
    pt.seed(0)
    model = pt.models.LlamaForCausalLM(cfg, device="cuda")
    n_params = model.num_params()
    batch, need, left = dist_reckoning(cfg, n_params, seq)
    heads = cfg.num_attention_heads
    dec = ar.route(batch * heads, seq, seq, cfg.hidden_size // heads,
                   torch.bfloat16, True, platform="cuda")
    log(f"dist (a): {name}, {n_params} params, {n_layers} layers; the "
        f"reckoning of a step without remat at b{batch} s{seq}: "
        f"{need / 2**30:.1f} GiB, {left / 2**30:.1f} GiB of the card left "
        f"(at least {DIST_FREE_GIB} asked); router fwd={dec.fwd} "
        f"bwd={dec.bwd} [{dec.source}]; built in "
        f"{time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                        device="cuda")
    with torch.no_grad():
        plain_loss = float(model(ids, labels=ids)[0])
    fwd = dec.fwd == "pallas"
    bwd = fwd and dec.bwd == "pallas"
    want = {"flash_fwd": n_layers if fwd else 0,
            "flash_bwd_dq": n_layers if bwd else 0,
            "flash_bwd_dkv": n_layers if bwd else 0}
    runs = {}
    # the one-process mesh first (DP_ONLY_RULES, stage 0): its tensors
    # wait on the host while the 2x2 mesh trains
    one = dist_train(model, (ids, ids), dist.Strategy(), spmd.DP_ONLY_RULES)
    one_tr = one[0]
    dist_check_chunks(one_tr, dp_like=True)
    runs["one-process"] = (one_tr.mesh.shape,) + one[1:]
    one_host = {k: v.detach().cpu() for k, v in dist_tensors(one_tr).items()}
    del one, one_tr
    gc.collect()
    torch.cuda.empty_cache()
    st = dist.Strategy()
    st.mp_degree = 2
    st.sharding.enable, st.sharding.degree, st.sharding.stage = True, 2, 3
    tr, losses, per_step, secs, launches, peak = dist_train(
        model, (ids, ids), st, spmd.LLAMA_SHARDING_RULES)
    runs["2x2"] = (tr.mesh.shape, losses, per_step, secs, launches, peak)
    checked = dist_check_chunks(tr, dp_like=False)
    tensors = dist_tensors(tr)
    same = all(torch.equal(v, one_host[k].to(v.device))
               for k, v in tensors.items())
    del one_host
    for label, (shape, ls, steps, s, _, pk) in runs.items():
        tps = batch * seq / (s / DIST_STEPS)
        mfu = train_llama.mfu(n_params, cfg, seq, tps, "cuda")
        log(f"dist (a): {label} mesh {shape}: step "
            f"{s / DIST_STEPS * 1e3:.1f} ms, {tps:.1f} tokens/s, MFU "
            f"{mfu if mfu is None else round(mfu, 4)}, launches a step "
            f"{steps[-1]}, peak memory {pk / 2**30:.2f} GiB, losses {ls}")
    gap = abs(losses[0] - plain_loss) / abs(plain_loss)
    log(f"dist (a): 2x2 (mp 2 x sharding 2, ZeRO stage 3) against the "
        f"one-process mesh: losses and {len(tensors)} parameters and "
        f"moments bitwise equal: {losses == runs['one-process'][1] and same}"
        f"; {checked} chunk maps as the ZeRO specs say; first loss "
        f"{losses[0]!r} against the plain model's {plain_loss!r} "
        f"(relative {gap:.3e}, tol {DIST_PLAIN_LOSS_RTOL:g})")
    if tr.mesh.shape != [1, 2, 1, 2, 1]:
        sys.exit(f"chip_smoke: to_static built mesh {tr.mesh.shape}")
    if losses != runs["one-process"][1] or not same:
        sys.exit("chip_smoke: the 2x2 layout changed the arithmetic")
    if not all(np.isfinite(losses)) or gap > DIST_PLAIN_LOSS_RTOL:
        sys.exit("chip_smoke: to_static's first loss is not the model's")
    for label, (_, _, steps, *_rest) in runs.items():
        for i, got in enumerate(steps):
            if got != want:
                sys.exit(f"chip_smoke: {label} step {i + 2} launched "
                         f"{got}, expected {want}")
    del tr
    t1 = time.perf_counter()
    dist_checkpoint(tensors)
    log(f"phase 25 (b): {time.perf_counter() - t1:.1f} s")
    del tensors, model
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    fleet_launches = dist_fleet()
    log(f"phase 25 (c): {time.perf_counter() - t1:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dist_data_parallel(tmp)
    log(f"phase 25 (d): {time.perf_counter() - t1:.1f} s")
    return {k: launches[k] + fleet_launches[k] for k in launches}


# ---------------------------------------------------------------------------
# phase 26: the pipeline schedules, ring attention, expert parallelism, the
# parameter server and the training guards
# ---------------------------------------------------------------------------

# (a): llama_1.3b over pp 4 in PIPE["micro"] micro-batches of b1 s2048 (the
# global b8 s2048 of phases 11 and 25), AdamW, 1 + PIPE["steps"] steps
PIPE = dict(pp=4, micro=8, steps=2, lr=3e-4, chunks=2)
# the first loss of FThenB, ZB and VPP against 1F1B's: the same eight
# micro-batch losses (each stage's forward is the same computation),
# summed in another order, relative
PIPE_FIRST_LOSS_RTOL = 1e-5
# 1F1B against the plain step (the model's own layers, the same loss, the
# same micro-batch accumulation) is held bit for bit: losses and every
# parameter after each step. FThenB's, ZB's and VPP's first-step gradients
# against 1F1B's, per layer and tensor, the largest relative L2: their
# autograd sums the micro-batches' bf16 contributions in another order.
# A planted fault, 1F1B's gradient with one of the eight micro-batches
# taken from another batch, must exceed the limit, which the phase checks.
# On an H100 the schedules read 4.5e-3 to 5.3e-3 and the fault 0.55
PIPE_GRAD_RTOL = 2e-2
# (b): llama_1.3b's heads over a sep ring of 4 at s32768 (8192 a shard)
RING = dict(b=1, s=32768, h=16, d=128, sep=4)
# its output against flash_attention_bshd over the whole sequence and the
# dense ring, and K1's at the ring's block against its plain version,
# relative L2: the outputs run from about 3 (the first queries) down to
# sqrt(e / 32768) = 0.009, so an absolute limit either passes a missing
# block or fails bf16's rounding of the large ones. A planted fault, the
# last shard's queries without the first K/V block, must exceed the limit,
# which the phase checks. On an H100 the ring read 1.2e-3 (causal) and
# 3.3e-3 (full) against flash_attention_bshd, 2.4e-3 against the dense
# ring, K1 at the block 2.9e-3 and 3.1e-3; the fault 0.11 and 0.29
RING_OUT_RTOL = 1e-2
RING_BWD_SEQS = (16384, 8192)
RING_BWD_FREE_GIB = 16
# bf16 gradients of the dense ring against K3/K4's, relative L2
RING_GRAD_RTOL = 2e-2
# (c): ExpertParallelMoE at Mixtral-8x7B's widths with GELU experts
EP_MOE = dict(d_model=4096, d_hidden=14336, experts=8, top_k=2, tokens=4096,
              ep=8)
# ep 8 against ep 1 where no token drops: bf16 products over 8 x 160
# slots against 4096, relative L2
EP_MOE_RTOL = 2e-2
# (d): a CTR model of Criteo's Display Advertising Challenge shape
CRITEO = dict(dense=13, sparse=26, dim=16, keys=2**24, zipf=1.2,
              batches=32, batch=4096, hidden=(400, 400, 400), lr=0.05,
              dense_lr=1e-3)
# the table against the CPU's after the card's first batch (PsBatch):
# adagrad's first step moves an element by lr * g / |g|, so only an
# element whose gradient is near zero may step the other way; the rest
# agree to float32 rounding. Those few signs, and Adam's as sign-like
# first step of the MLP, feed the next batch, so from the second batch on
# the two runs are no longer the same computation (on an H100, 0.969 of
# the second batch's new rows' elements agreed): the table is printed there, and
# each channel's first two steps (PsBatch, then PsEmbedding) are held by
# redoing them on the CPU from the card's own MLP and inputs: the pushed
# rows' gradients, relative L2. A frequent id's gradient sums hundreds of
# samples' that nearly cancel, so float32 itself strays: at the first
# step the CPU's float32 read 7.9e-5 from its float64 and the card 2.5e-4
# from the CPU (on an H100; 4.1e-7 at the second step). A planted fault,
# one sample's gradients lost, read 3.2e-3 and 2.0e-2 and must exceed the
# limit, which the phase checks
PS_ROW_ATOL = 1e-4
PS_ROW_SHARE = 0.999
PS_GRAD_RTOL = 1e-3
# (e): the watchdog's timeout and the step that sleeps past it, seconds
GUARD_TIMEOUT, GUARD_SLEEP = 0.5, 1.5


def pipe_launches(schedule, m, layers, pp):
    """K1 and K3/K4 launches a step of `schedule` with m micro-batches over
    `layers` layers on pp stages, when the attention routes to the
    kernels: 1F1B and ZB run the forward of every stage but the last
    without grad and each stage again inside its backward (ZB's batched
    weight gradient once more, over all micro-batches); FThenB and VPP
    remat each stage's forward in the backward; the plain step runs each
    layer once."""
    k1, k34 = {"1F1B": (m * (layers - layers // pp) + m * layers,
                        m * layers),
               "ZB": (m * (layers - layers // pp) + m * layers + layers,
                      m * layers + layers),
               "FThenB": (2 * m * layers, m * layers),
               "VPP": (2 * m * layers, m * layers),
               "plain": (m * layers, m * layers)}[schedule]
    return {"flash_fwd": k1, "flash_bwd_dq": k34, "flash_bwd_dkv": k34}


def launch_delta(before):
    return {k: v - before[k] for k, v in kernel_launches().items()}


def pipe_step(runner, ids, labels, on_grads=None):
    """One runner step; (loss, launches, seconds, the schedule's peak bytes
    above the memory allocated at its start: its forward and backward,
    the gradients included, before the optimizer's update). `on_grads`
    sees the step's gradients before the update."""
    torch.cuda.synchronize()
    start = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    before = kernel_launches()
    t0 = time.perf_counter()
    loss, grads = runner.grads(ids, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - start
    launches, seconds = launch_delta(before), time.perf_counter() - t0
    if on_grads is not None:
        on_grads(per_layer_grads(runner, grads))
    t1 = time.perf_counter()
    runner.update(grads)
    loss = float(loss)
    torch.cuda.synchronize()
    return loss, launches, seconds + time.perf_counter() - t1, peak


def per_layer_grads(runner, grads):
    """The (demb, dstage, dhead) of `runner.grads` by tensor and layer,
    whatever the schedule's stacking (VPP's [s, c] is virtual stage
    c * pp + s)."""
    demb, dstage, dhead = grads
    out = {f"embed.{k}": v for k, v in demb.items()}
    out.update({f"head.{k}": v for k, v in dhead.items()})
    lead = 2
    for k, v in dstage.items():
        if runner.schedule == "VPP":
            v, lead = v.transpose(0, 1), 3
        v = v.reshape((-1,) + v.shape[lead:])
        out.update({f"layer{i}.{k}": v[i] for i in range(v.shape[0])})
    return out


def grad_gap(got, want):
    """(bitwise equal, the largest relative L2 over tensors and layers)."""
    return (all(torch.equal(got[k], want[k]) for k in want),
            max(rel_err(got[k], want[k]) for k in want))


def plain_pipe_step(model, opt, ids, m):
    """The plain step: each micro-batch through the model's own layers and
    the runner's loss, loss / m backward, then one AdamW step."""
    from paddle_tpu_torch.parallel.functional import rmsnorm_lm_loss
    llama, eps = model.llama, model.config.rms_norm_eps
    total = torch.zeros((), dtype=torch.float32, device="cuda")
    for tok in ids.chunk(m):
        h = torch.nn.functional.embedding(tok, llama.embed_tokens.weight)
        for layer in llama.layers:
            h = layer(h)
        loss = rmsnorm_lm_loss(llama.norm.weight, model.lm_head.weight, h,
                               tok, eps)
        (loss * (1.0 / m)).backward()
        total += loss.detach().float() * (1.0 / m)
    opt.step()
    opt.clear_grad()
    return float(total)


def pipe_against_plain(runner, model):
    """(bitwise equal, largest |difference|) of every runner tensor against
    the model's parameter it stacks."""
    lps, worst, same = runner.layers_per_stage, 0.0, True
    pairs = [(runner.embed_params["weight"], model.llama.embed_tokens.weight),
             (runner.head_params["norm"], model.llama.norm.weight),
             (runner.head_params["lm_head"], model.lm_head.weight)]
    layers = model.llama.layers
    for name, t in runner.stage_params.items():
        for s in range(t.shape[0]):
            for j in range(lps):
                mod = layers[s * lps + j]
                for part in name.split("."):
                    mod = getattr(mod, part)
                pairs.append((t[s, j], mod))
    for a, b in pairs:
        same = same and torch.equal(a, b.detach())
        worst = max(worst, float((a.float() - b.detach().float()).abs().max()))
    return same, worst


def pipe_reckoning(cfg, n_params, m, seq):
    """Bytes FThenB keeps beside the weights, the runner's copy, its AdamW
    moments and gradients (bf16): each stage's input for every
    micro-batch (remat) and each micro-batch's head (bf16 logits and two
    float32 copies for the log-softmax), as phase 25's reckoning counts
    them; and the bytes left on the card."""
    state = 2 * n_params * 5
    keep = m * PIPE["pp"] * seq * cfg.hidden_size * 2 + \
        m * seq * cfg.vocab_size * (2 + 4 + 4)
    total = torch.cuda.get_device_properties(0).total_memory
    return state, keep, total - state - keep


def pipe_runner(model, mesh, schedule, m):
    from paddle_tpu_torch.parallel.llama_pipeline import LlamaPipeRunner
    opt = optimizer.AdamW(PIPE["lr"], parameters=model.parameters())
    return LlamaPipeRunner(model, mesh, m, optimizer=opt, schedule=schedule,
                           num_chunks=PIPE["chunks"])


def restore_model(model, host):
    with torch.no_grad():
        for k, v in model.state_dict().items():
            v.copy_(host[k])


def phase26_pipeline():
    """(a); returns the 1F1B runner (for (e)), its batches, the model and
    its host copy, and the launches of the main path's runs."""
    name, cfg, batch, seq, *_ = train_llama.llama_ladder()[0]
    m, pp, steps = PIPE["micro"], PIPE["pp"], PIPE["steps"]
    layers = cfg.num_hidden_layers
    pt.seed(0)
    model = pt.models.LlamaForCausalLM(cfg, device="cuda")
    n_params = model.num_params()
    host = {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}
    mesh = pt.distributed.ProcessMesh(shape=[pp], dim_names=["pp"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (steps + 1, batch, seq),
                        generator=gen, device="cuda")
    heads = cfg.num_attention_heads
    dec = ar.route(batch // m * heads, seq, seq, cfg.hidden_size // heads,
                   torch.bfloat16, True, platform="cuda")
    state, keep, left = pipe_reckoning(cfg, n_params, m, seq)
    fits = left >= DIST_FREE_GIB * 2**30
    fthenb_m = m if fits else m // 2
    log(f"pipe (a): {name}, {n_params} params, {layers} layers over pp "
        f"{pp} ({layers // pp} a stage), b{batch} s{seq} in {m} micro-batches"
        f" of b{batch // m}; the router at (bh {batch // m * heads}, "
        f"s{seq}, d{cfg.hidden_size // heads}, bf16, causal): fwd={dec.fwd} "
        f"bwd={dec.bwd} [{dec.source}]; the stages run K1/K3/K4 "
        f"(FLAGS_flash_attention_backend and _bwd = pallas); FThenB's "
        f"reckoning: {state / 2**30:.1f} GiB of weights, copy, moments and "
        f"gradients, {keep / 2**30:.2f} GiB of stage inputs and heads, "
        f"{left / 2**30:.1f} GiB left (at least {DIST_FREE_GIB} asked): "
        f"FThenB in {fthenb_m} micro-batches")
    runs, ref = {}, {}

    def keep(grads):
        ref.update({k: v.clone() for k, v in grads.items()})
    runner = pipe_runner(model, mesh, "1F1B", m)
    for i in range(steps + 1):
        runs.setdefault("1F1B", []).append(pipe_step(
            runner, ids[i], ids[i], keep if i == 0 else None))
    opt = optimizer.AdamW(PIPE["lr"], parameters=model.parameters())
    torch.cuda.synchronize()
    before = kernel_launches()
    t0 = time.perf_counter()
    plain = [plain_pipe_step(model, opt, ids[i], m) for i in range(steps + 1)]
    plain_s = time.perf_counter() - t0
    plain_launches = launch_delta(before)
    del opt
    same, worst = pipe_against_plain(runner, model)
    losses = [r[0] for r in runs["1F1B"]]
    log(f"pipe (a): 1F1B losses {losses}, the plain step's {plain}, equal: "
        f"{losses == plain}; parameters after {steps + 1} steps bit for bit "
        f"equal: {same}, largest |difference| {worst:.3e}; the plain step "
        f"{plain_s / (steps + 1) * 1e3:.1f} ms, launches over its "
        f"{steps + 1} steps {plain_launches}")
    if not (all(np.isfinite(losses)) and losses == plain and same):
        sys.exit("chip_smoke: 1F1B over pp 4 does not train bit for bit as "
                 "the plain step")
    if plain_launches != {k: v * (steps + 1) for k, v in pipe_launches(
            "plain", m, layers, pp).items()}:
        sys.exit(f"chip_smoke: the plain step launched {plain_launches}")
    restore_model(model, host)
    gaps = {}
    for schedule in ("FThenB", "ZB", "VPP"):
        mm = fthenb_m if schedule == "FThenB" else m
        other = pipe_runner(model, mesh, schedule, mm)
        runs[schedule] = [pipe_step(
            other, ids[0], ids[0],
            lambda g, k=schedule: gaps.__setitem__(k, grad_gap(g, ref)))]
        del other
        gc.collect()
        torch.cuda.empty_cache()
    # the planted fault: 1F1B's first gradients with the last micro-batch
    # taken from the next batch
    bad = ids[0].clone()
    bad[-(batch // m):] = ids[1][-(batch // m):]
    other = pipe_runner(model, mesh, "1F1B", m)
    fault = grad_gap(per_layer_grads(other, other.grads(bad, bad)[1]), ref)[1]
    del other, ref
    gc.collect()
    torch.cuda.empty_cache()
    log(f"pipe (a): first-step gradients against 1F1B's, per tensor and "
        f"layer (bit for bit, largest relative L2; tol {PIPE_GRAD_RTOL:g}): "
        + ", ".join(f"{k} ({v[0]}, {v[1]:.3e})" for k, v in gaps.items())
        + f"; the planted fault (one micro-batch from another batch) "
        f"{fault:.3e}")
    if not (fault > PIPE_GRAD_RTOL
            and all(v[1] <= PIPE_GRAD_RTOL for v in gaps.values())):
        sys.exit("chip_smoke: a schedule's gradients are not 1F1B's, or the "
                 "check cannot tell a wrong gradient")
    first = runs["1F1B"][0][0]
    main = {k: 0 for k in kernel_launches()}
    for schedule, rs in runs.items():
        mm = fthenb_m if schedule == "FThenB" else m
        want = pipe_launches(schedule, mm, layers, pp)
        tps = batch * seq / rs[-1][2]
        mfu = train_llama.mfu(n_params, cfg, seq, tps, "cuda")
        log(f"pipe (a): {schedule} [{CARD}]: step {rs[-1][2] * 1e3:.1f} ms "
            f"(its step {len(rs)} of {len(rs)}), {tps:.1f} tokens/s, MFU "
            f"{mfu if mfu is None else round(mfu, 4)}, launches a step "
            f"{rs[-1][1]} (expected {want}), the schedule's peak memory "
            f"above the step's start {rs[-1][3] / 2**30:.2f} GiB, first "
            f"loss {rs[0][0]!r}")
        for r in rs:
            if r[1] != want:
                sys.exit(f"chip_smoke: {schedule} launched {r[1]}, expected "
                         f"{want}")
            for k in main:
                main[k] += r[1][k]
        if schedule != "1F1B" and (abs(rs[0][0] - first) / abs(first)
                                   > PIPE_FIRST_LOSS_RTOL):
            sys.exit(f"chip_smoke: {schedule}'s first loss {rs[0][0]!r} is "
                     f"not 1F1B's {first!r}")
    # the activations' share of each schedule's peak: the peak less the
    # gradients' bytes (1F1B allocates its gradients before its ticks, so
    # its share is exact; FThenB's autograd allocates them as it goes, so
    # its share is a lower bound)
    grad_bytes = 2 * n_params
    acts = {k: rs[-1][3] - grad_bytes for k, rs in runs.items()}
    log(f"pipe (a): the schedules' peaks less the gradients' "
        f"{grad_bytes / 2**30:.2f} GiB: "
        + ", ".join(f"{k} {v / 2**30:.2f} GiB" for k, v in acts.items()))
    if not acts["1F1B"] < acts["FThenB"]:
        sys.exit("chip_smoke: 1F1B keeps more activations than FThenB")
    return runner, ids, model, host, main


def ring_inputs(b, s, h, d, seed, mesh=None, grad=False):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    out = []
    for _ in range(3):
        x = torch.randn(b, s, h, d, generator=gen, device="cuda",
                        dtype=torch.bfloat16)
        if mesh is not None:
            x = pt.distributed.shard_tensor(x, mesh,
                                            [pt.distributed.Shard(1)])
        out.append(x.requires_grad_(grad))
    return out


def ring_dense_bytes(b, s, h, n):
    """What autograd keeps of the dense ring: three float32 (b, h, s/n,
    s/n) tensors for each shard's each ring step (the scores' max input,
    exp's output and the masked probabilities)."""
    sl = s // n
    return n * n * 3 * 4 * b * h * sl * sl


def ring_fault(out, q, k, v, n, causal):
    """`out` with the last shard's queries attending to every block but
    the first: what a ring that drops that shard's last step computes.
    By SDPA with a mask, a check of the check only."""
    sl = q.shape[1] // n
    qs, ks, vs = (x.transpose(1, 2) for x in (q[:, (n - 1) * sl:],
                                               k[:, sl:], v[:, sl:]))
    mask = None
    if causal:
        mask = (torch.arange(ks.shape[2], device=q.device)[None]
                <= torch.arange(sl, device=q.device)[:, None] + (n - 2) * sl)
    bad = out.clone()
    bad[:, (n - 1) * sl:] = torch.nn.functional.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask).transpose(1, 2)
    return bad


def ring_k1_rows():
    """K1 at the ring's block shape, causal and not: device time of 20
    graph-replayed calls, the plain version, SDPA and the bound."""
    r = RING
    sl = r["s"] // r["sep"]
    rows = {}
    for causal in (True, False):
        q, k, v = ring_inputs(r["b"], sl, r["h"], r["d"], 7)
        qf, kf, vf = (x.transpose(1, 2).reshape(r["b"] * r["h"], sl, r["d"])
                      .contiguous() for x in (q, k, v))
        scale = 1.0 / r["d"] ** 0.5
        with torch.inference_mode():
            out, lse = fa._flash_fwd_bhsd(qf, kf, vf, causal, scale)
            ref, ref_lse = fa._flash_fwd_bhsd_plain(qf, kf, vf, causal, scale)
            err = float((out.float() - ref.float()).abs().max())
            rel = rel_err(out, ref)
            err_lse = float((lse - ref_lse).abs().max())
            del ref, ref_lse
            ms = device_ms(lambda: fa._flash_fwd_bhsd(qf, kf, vf, causal,
                                                      scale))
            plain_ms = time_ms(lambda: fa._flash_fwd_bhsd_plain(
                qf, kf, vf, causal, scale), reps=5, warmup=1)
            ql, kl, vl = (x.transpose(1, 2) for x in (q, k, v))
            library_ms = device_ms(lambda: library_attention(ql, kl, vl,
                                                             causal))
        bound, bound_by = k1_bound_ms(r["b"], r["h"], r["h"], sl, sl, r["d"],
                                      causal)
        rows["causal" if causal else "full"] = dict(
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=bound_by, library_ms=library_ms)
        log(f"ring (b): K1 at the ring's block (b{r['b']} h{r['h']} "
            f"{sl}x{sl} d{r['d']} bf16, {'causal' if causal else 'full'}) "
            f"[{CARD}]: {ms:.4f} ms (20 graph-replayed calls), plain "
            f"{plain_ms:.3f} ms, sdpa {library_ms:.4f} ms, bound "
            f"{bound:.4f} ms ({bound_by}), max|err| {err:.3e}, relative L2 "
            f"{rel:.3e} (tol {RING_OUT_RTOL:g}), max|lse err| {err_lse:.3e} "
            f"(tol {LSE_ATOL:g})")
        if not (rel <= RING_OUT_RTOL and err_lse <= LSE_ATOL):
            sys.exit("chip_smoke: K1 disagrees with its plain version at "
                     "the ring's block")
    return rows


def rel_err(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def phase26_ring():
    """(b); returns the K1 launches of its ring calls and the K1 rows."""
    from paddle_tpu_torch.ops.ring_attention import ring_attention
    r = RING
    n = r["sep"]
    mesh = pt.distributed.ProcessMesh(shape=[n], dim_names=["sep"])
    q, k, v = ring_inputs(r["b"], r["s"], r["h"], r["d"], 0, mesh)
    launches = 0
    for causal in (True, False):
        with torch.no_grad():
            torch.cuda.synchronize()
            before = fa.flash_fwd_launches
            t0 = time.perf_counter()
            out = ring_attention(q, k, v, "sep", causal=causal)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            got = fa.flash_fwd_launches - before
            launches += got
            call_ms = time_ms(lambda: ring_attention(q, k, v, "sep",
                                                     causal=causal),
                              reps=3, warmup=1)
            whole = fa.flash_attention_bshd(q, k, v, causal=causal)
            err_whole = rel_err(out, whole)
            fault = rel_err(ring_fault(out, q, k, v, n, causal), whole)
            del whole
            err_dense = None
            if causal:
                dense = ring_attention(q, k, v, "sep", causal=True,
                                       use_flash=False)
                err_dense = rel_err(out, dense)
                del dense
            ok = (got == n and err_whole <= RING_OUT_RTOL
                  and (err_dense is None or err_dense <= RING_OUT_RTOL)
                  and fault > RING_OUT_RTOL
                  and bool(torch.isfinite(out).all()))
        log(f"ring (b): b{r['b']} s{r['s']} h{r['h']} d{r['d']} bf16 over "
            f"sep {n} ({r['s'] // n} a shard), {'causal' if causal else 'full'}"
            f" [{CARD}]: K1 launches {got} a call, first call {ms:.1f} ms, "
            f"{call_ms:.2f} ms a call (median of 3); relative L2 against "
            f"flash_attention_bshd over the whole sequence {err_whole:.3e}"
            + (f", against the dense ring {err_dense:.3e}" if causal else "")
            + f" (tol {RING_OUT_RTOL:g}); the planted fault (shard {n - 1} "
            f"without block 0) {fault:.3e}: {'ok' if ok else 'FAIL'}")
        if not ok:
            sys.exit("chip_smoke: the ring does not compute attention over "
                     "the whole sequence")
    del q, k, v, out
    gc.collect()
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    seq = next((s for s in RING_BWD_SEQS
                if free - ring_dense_bytes(r["b"], s, r["h"], n)
                >= RING_BWD_FREE_GIB * 2**30), RING_BWD_SEQS[-1])
    log(f"ring (b): the backward's reckoning: the dense ring keeps "
        + ", ".join(f"{ring_dense_bytes(r['b'], s, r['h'], n) / 2**30:.1f} "
                    f"GiB at s{s}" for s in RING_BWD_SEQS)
        + f"; {free / 2**30:.1f} GiB free, at least {RING_BWD_FREE_GIB} to "
        f"be left: s{seq}")
    q, k, v = ring_inputs(r["b"], seq, r["h"], r["d"], 1, mesh, grad=True)
    gen = torch.Generator(device="cuda").manual_seed(2)
    g = torch.randn(r["b"], seq, r["h"], r["d"], generator=gen,
                    device="cuda", dtype=torch.bfloat16)
    before = fa.flash_fwd_launches
    t0 = time.perf_counter()
    out = ring_attention(q, k, v, "sep", causal=True)
    grads = torch.autograd.grad(out, (q, k, v), g)
    torch.cuda.synchronize()
    bwd_s = time.perf_counter() - t0
    got = fa.flash_fwd_launches - before
    launches += got
    peak = torch.cuda.max_memory_allocated()
    del out
    qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
    want = torch.autograd.grad(fa.flash_attention_bshd(qd, kd, vd,
                                                       causal=True),
                               (qd, kd, vd), g)
    errs = [rel_err(a, b) for a, b in zip(grads, want)]
    log(f"ring (b): the backward at s{seq} through the dense ring "
        f"[{CARD}]: {bwd_s:.2f} s forward and backward, K1 launches {got}, "
        f"peak memory {peak / 2**30:.1f} GiB; dq, dk, dv against K3/K4's "
        f"over the whole sequence: relative L2 {[f'{e:.3e}' for e in errs]}"
        f" (tol {RING_GRAD_RTOL})")
    del q, k, v, grads, want, qd, kd, vd
    gc.collect()
    torch.cuda.empty_cache()
    if got != n or not all(e <= RING_GRAD_RTOL for e in errs):
        sys.exit("chip_smoke: the ring's gradients are not attention's")
    return launches, ring_k1_rows()


def phase26_moe():
    """(c): ExpertParallelMoE at Mixtral-8x7B's widths over ep 8."""
    from paddle_tpu_torch.parallel.moe import (ExpertParallelMoE,
                                               dropped_choices, moe_capacity)
    c = EP_MOE
    d, h, e, k, t, ep = (c[x] for x in ("d_model", "d_hidden", "experts",
                                        "top_k", "tokens", "ep"))
    mesh = pt.distributed.ProcessMesh(shape=[ep], dim_names=["ep"])
    layer = ExpertParallelMoE(d, h, e, mesh=mesh, top_k=k)
    params = layer.init(0, torch.bfloat16)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(t, d, generator=gen, device="cuda", dtype=torch.bfloat16)
    with torch.no_grad():
        roomy = e / k
        a, _ = ExpertParallelMoE(d, h, e, mesh=mesh, top_k=k,
                                 capacity_factor=roomy).apply(params, x)
        b, _ = ExpertParallelMoE(d, h, e, top_k=k,
                                 capacity_factor=roomy).apply(params, x)
        err = rel_err(a, b)
        del a, b
        logits = x @ params["gate"]
        cap = moe_capacity(t // ep, e, layer.capacity_factor, k)
        dropped = sum(dropped_choices(lg, e, cap, k)
                      for lg in logits.chunk(ep))
    for p in params.values():
        p.requires_grad_()
    xg = x.detach().requires_grad_()

    def fwd_bwd():
        out, aux = layer.apply(params, xg)
        (out.float().pow(2).mean() + aux.float()).backward()
        for p in list(params.values()) + [xg]:
            p.grad = None
        return out.detach(), float(aux.detach())

    fwd_bwd()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(3):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        out, aux = fwd_bwd()
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
    peak = torch.cuda.max_memory_allocated()
    # the experts' two products on each kept (token, choice), forward and
    # twice backward, and the gate's
    useful = 3 * (2 * 2 * (t * k - dropped) * d * h + 2 * t * d * e)
    best = min(ms) / 1e3
    dense = (f"phase 23 (c)'s dense MoELayer (SwiGLU experts) at the same "
             f"widths: {MOE_DENSE['ms']:.3f} ms, "
             f"{MOE_DENSE['useful_tflops']:.1f} useful TFLOP/s, peak "
             f"{MOE_DENSE['peak_gib']:.2f} GiB" if MOE_DENSE
             else "phase 23 (c) did not run in this call")
    log(f"moe (c): ExpertParallelMoE d_model {d}, {e} GELU experts of {h}, "
        f"top-{k}, bf16, {t} tokens over ep {ep} [{CARD}]: ep {ep} against "
        f"ep 1 at capacity factor {roomy:g} (no drop): relative L2 "
        f"{err:.3e} (tol {EP_MOE_RTOL}); at capacity factor "
        f"{layer.capacity_factor} ({cap} slots an expert a shard) "
        f"{dropped} of {t * k} (token, choice) pairs dropped; forward and "
        f"backward ms {[round(v, 3) for v in ms]}, {useful / best / 1e12:.1f}"
        f" useful TFLOP/s, peak memory {peak / 2**30:.2f} GiB, aux loss "
        f"{aux:.6f}; beside {dense}")
    del params, x, xg, out, layer
    gc.collect()
    torch.cuda.empty_cache()
    if not err <= EP_MOE_RTOL or not math.isfinite(aux):
        sys.exit("chip_smoke: expert parallelism is not the local layer")


CRITEO_GEN = r'''
import sys
import numpy as np
from paddle_tpu_torch.distributed.dataset import MultiSlotDataGenerator
out, n, dense_n, sparse_n, keys, a = sys.argv[1], *map(float, sys.argv[2:])
n, dense_n, sparse_n, keys = int(n), int(dense_n), int(sparse_n), int(keys)
rng = np.random.default_rng(0)
label = (rng.random(n) < 0.25).astype(np.int64)
dense = np.log1p(rng.poisson(3.0, (n, dense_n))).astype(np.float32)
raw = (rng.zipf(a, (n, sparse_n)) % keys).astype(np.uint64)
slot = np.arange(sparse_n, dtype=np.uint64)[None]
with np.errstate(over="ignore"):
    ids = (raw * np.uint64(0x9E3779B97F4A7C15)) ^ (slot << np.uint64(56))
ids = (ids >> np.uint64(1)).astype(np.int64)


class Criteo(MultiSlotDataGenerator):
    def generate_sample(self, line):
        i = int(line)

        def sample():
            yield ([("label", [int(label[i])]), ("dense", dense[i].tolist())]
                   + [(f"C{j}", [int(ids[i, j])]) for j in range(sparse_n)])
        return sample


lines = Criteo().run_from_memory([str(i) for i in range(n)])
with open(out, "w") as f:
    f.write("\n".join(lines) + "\n")
'''

PS_SERVER = r'''
import sys
from paddle_tpu_torch.distributed import ps, rpc
endpoint, dim, lr = sys.argv[1], int(sys.argv[2]), float(sys.argv[3])
rpc.init_rpc(ps.the_one_ps.server_name(0), rank=1, world_size=2,
             master_endpoint=endpoint)
ps.TheOnePs([ps.TableConfig(0, dim, ps.CtrAccessor(
    ps.SparseAdaGradRule(learning_rate=lr)))]).start_server(0)
rpc.shutdown()
'''


class _FloatSlot:
    def __init__(self, name):
        self.name, self.dtype = name, "float32"


class TimedSource:
    """A PS client whose pulls and pushes are timed (host seconds)."""

    def __init__(self, client):
        self.client, self.pull_s, self.push_s = client, 0.0, 0.0
        self.pushed = None

    def pull_unique(self, table_id, ids):
        t0 = time.perf_counter()
        out = self.client.pull_unique(table_id, ids)
        self.pull_s += time.perf_counter() - t0
        return out

    def push_unique(self, table_id, ids, grads):
        pushed = (np.array(ids, copy=True),
                  np.array(grads, np.float32, copy=True))
        t0 = time.perf_counter()
        self.client.push_unique(table_id, ids, grads)
        self.push_s += time.perf_counter() - t0
        self.pushed = pushed


def ctr_model(device):
    """DeepFM's deep part: the 13 dense features and the 26 pooled
    embeddings through a 400-400-400 MLP to one logit, float32, drawn on
    the CPU from seed(0) (the CPU's and the card's generators differ) and
    moved to `device`."""
    c = CRITEO
    pt.seed(0)
    width = c["dense"] + c["sparse"] * c["dim"]
    layers = []
    for w in c["hidden"]:
        layers += [pt.nn.Linear(width, w, device="cpu"), pt.nn.ReLU()]
        width = w
    return pt.nn.Sequential(*layers, pt.nn.Linear(width, 1, device="cpu")) \
        .to(device)


def ctr_run(batches, client, device):
    """The 32 batches through PsBatch (even steps) and PsEmbedding (odd),
    the MLP on `device`; the embedding rows' gradients are summed by id on
    the host, so every run pushes the same rows. Returns the seconds,
    the host and device seconds, the pulls' and pushes' seconds, the
    unique ids a batch, for an in-process client the table's (keys, rows)
    after the first batch (PsBatch) and after the second (PsEmbedding),
    and for each of those two steps what ps_step_on_cpu needs to redo
    it: the MLP before it, its inputs and what it
    pushed."""
    from paddle_tpu_torch.distributed import ps
    c = CRITEO
    src = TimedSource(client)
    model = ctr_model(device)
    opt = optimizer.Adam(c["dense_lr"], parameters=model.parameters())
    emb = ps.PsEmbedding(c["dim"], src, device=device)
    bracket = ps.PsBatch(src, 0, c["dim"], c["batch"] * c["sparse"],
                         device=device)
    cuda = torch.device(device).type == "cuda"
    device_s, uniq, snaps, probes = 0.0, [], [], []
    t0 = time.perf_counter()
    for i, batch in enumerate(batches):
        ids = np.stack([batch[f"C{j}"][0] for j in range(c["sparse"])], 1)
        dense = torch.from_numpy(batch["dense"][0].reshape(
            -1, c["dense"])).to(device)
        label = torch.from_numpy(batch["label"][0]).to(device)
        uniq.append(len(np.unique(ids)))
        if i % 2 == 0:
            rows, inv = bracket.prepare(ids)
            e = rows[inv].detach().requires_grad_()
        else:
            e = emb(torch.from_numpy(ids).to(device))
        if i < 2:
            probes.append(dict(
                mlp=[p.detach().to("cpu", copy=True)
                     for p in model.parameters()],
                dense=dense.cpu(), label=label.cpu(), e=e.detach().cpu(),
                ids=ids))
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
            start.record()
        logit = model(torch.cat([dense, e.reshape(len(label), -1)], 1))
        loss = torch.nn.functional.binary_cross_entropy_with_logits(
            logit[:, 0], label.float())
        loss.backward()
        opt.step()
        opt.clear_grad()
        if cuda:
            end.record()
            end.synchronize()
            device_s += start.elapsed_time(end) / 1e3
        if i % 2 == 0:
            g = e.grad.reshape(-1, c["dim"]).float().cpu().numpy()
            inv_np = inv.cpu().numpy()
            drows = np.zeros((c["batch"] * c["sparse"], c["dim"]), np.float32)
            np.add.at(drows, inv_np, g)
            bracket.complete(drows)
        if i < 2:
            probes[-1]["pushed"] = src.pushed
        if i < 2 and isinstance(client.channels[0], ps.LocalChannel):
            keys = np.sort(client.channels[0].server.tables[0].keys())
            snaps.append((keys, table_rows(client, keys)))
    total = time.perf_counter() - t0
    return (total, total - device_s, device_s, src.pull_s, src.push_s, uniq,
            snaps, probes)


def ps_step_on_cpu(probe):
    """Redo one of the card's CTR steps on the CPU from the same MLP and
    inputs, in float32 and in float64, and sum the rows' gradients by id
    as the push does. Returns the relative L2 of the card's pushed
    gradients against the CPU's float32 ones, that of the CPU's float32
    against its float64 (how far float32 itself is from exact here), and
    that of a planted fault (the first sample's gradients lost)."""
    c = CRITEO
    uniq, inv = np.unique(probe["ids"].reshape(-1).astype(np.uint64),
                          return_inverse=True)
    inv = inv.reshape(-1)
    ids, got = probe["pushed"]
    if not np.array_equal(np.asarray(ids, np.uint64), uniq):
        return float("inf"), 0.0, 0.0
    out = {}
    for dtype in (torch.float32, torch.float64):
        model = ctr_model("cpu").to(dtype)
        with torch.no_grad():
            for p, q in zip(model.parameters(), probe["mlp"]):
                p.copy_(q)
        e = probe["e"].to(dtype, copy=True).requires_grad_()
        logit = model(torch.cat([probe["dense"].to(dtype), e.reshape(
            len(probe["label"]), -1)], 1))
        torch.nn.functional.binary_cross_entropy_with_logits(
            logit[:, 0], probe["label"].to(dtype)).backward()
        g = e.grad.reshape(-1, c["dim"]).numpy()
        out[dtype] = np.zeros((len(uniq), c["dim"]), g.dtype)
        np.add.at(out[dtype], inv, g)
    want, exact = out[torch.float32], out[torch.float64]
    lost = want.copy()
    np.add.at(lost, inv[:c["sparse"]], -g[:c["sparse"]].astype(np.float32))

    def rel(a, b):
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return rel(got[:len(uniq)], want), rel(want, exact), rel(lost, want)


def table_rows(client, keys):
    return client.pull_unique(0, keys)


def ctr_parse(gen_proc, data_path):
    """Wait for the generator, then read its file with InMemoryDataset on
    a thread (beside (e)); returns the thread and a dict that receives the
    dataset and the parse seconds."""
    from paddle_tpu_torch.distributed import InMemoryDataset
    c = CRITEO
    out, err = gen_proc.communicate(timeout=300)
    if gen_proc.returncode != 0:
        sys.exit(f"chip_smoke: the Criteo generator failed:\n{err}")
    data = InMemoryDataset()
    data.init(batch_size=c["batch"], use_var=[
        _FloatSlot("label"), _FloatSlot("dense")]
        + [f"C{j}" for j in range(c["sparse"])])
    data.set_filelist([data_path])
    parsed = {}

    def load():
        t0 = time.perf_counter()
        data.load_into_memory()
        parsed.update(data=data, seconds=time.perf_counter() - t0)

    thread = threading.Thread(target=load, daemon=True)
    thread.start()
    return thread, parsed


def phase26_ps(parse):
    """(d): the CTR model's steps over LocalChannel and RpcChannel, the
    same run on the CPU, and a save/load round trip."""
    from paddle_tpu_torch.distributed import ps, rpc
    c = CRITEO
    thread, parsed = parse
    thread.join()
    batches = list(parsed["data"])
    parse_s = parsed["seconds"]
    cfgs = [ps.TableConfig(0, c["dim"], ps.CtrAccessor(
        ps.SparseAdaGradRule(learning_rate=c["lr"])))]
    port = free_port()
    server = subprocess.Popen(
        [sys.executable, "-c", PS_SERVER, f"127.0.0.1:{port}",
         str(c["dim"]), str(c["lr"])], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        local = ps.TheOnePs(cfgs).start_local()
        runs = {"local": ctr_run(batches, local, "cuda")}
        keys = np.sort(local.channels[0].server.tables[0].keys())
        rows = {"local": table_rows(local, keys)}
        rpc.init_rpc("trainer_0", rank=0, world_size=2,
                     master_endpoint=f"127.0.0.1:{port}")
        try:
            remote = ps.TheOnePs(cfgs).connect([ps.the_one_ps.server_name(0)])
            runs["rpc"] = ctr_run(batches, remote, "cuda")
            rows["rpc"] = table_rows(remote, keys)
            remote_rows = remote.stats()[0][0]
        finally:
            rpc.shutdown()
        server.communicate(timeout=60)
    finally:
        if server.poll() is None:
            server.kill()
            server.wait()
    cpu = ps.TheOnePs(cfgs).start_local()
    cpu_snaps = ctr_run(batches, cpu, "cpu")[-2]
    rows["cpu"] = table_rows(cpu, keys)
    # the CPU against itself: the same 32 batches on one intra-op thread
    # (the run above takes torch's default), the gap the card's is read by
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cpu1 = ps.TheOnePs(cfgs).start_local()
        ctr_run(batches, cpu1, "cpu")
        rows["cpu1"] = table_rows(cpu1, keys)
    finally:
        torch.set_num_threads(threads)
    same = np.array_equal(rows["local"], rows["rpc"])
    card_snaps = runs["local"][-2]
    steps = {(label, i): ps_step_on_cpu(p) for label, r in runs.items()
             for i, p in enumerate(r[-1])}

    def agree(a, b):
        return (float((np.abs(a - b) <= PS_ROW_ATOL).mean()),
                float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    same_keys = all(np.array_equal(a[0], b[0])
                    for a, b in zip(card_snaps, cpu_snaps))
    if same_keys:
        share, rel = agree(card_snaps[0][1], cpu_snaps[0][1])
        new = ~np.isin(card_snaps[1][0], card_snaps[0][0])
        share1, rel1 = agree(card_snaps[1][1][new], cpu_snaps[1][1][new])
        whole1, _ = agree(card_snaps[1][1], cpu_snaps[1][1])
    else:
        share = share1 = whole1 = 0.0
        rel = rel1 = float("inf")
        new = np.zeros(0, bool)
    end_share, end_rel = agree(rows["local"], rows["cpu"])
    self_share, self_rel = agree(rows["cpu1"], rows["cpu"])
    with tempfile.TemporaryDirectory() as tmp:
        eng = ps.TheOnePs(cfgs)
        eng.client = local
        t1 = time.perf_counter()
        eng.save(tmp)
        fresh = ps.TheOnePs(cfgs)
        fresh.start_local()
        fresh.load(tmp)
        io_s = time.perf_counter() - t1
        reloaded = np.array_equal(table_rows(fresh.client, keys),
                                  rows["local"])
        n_fresh = len(fresh.servers[0].tables[0])
    n = c["batches"] * c["batch"]
    for label, (total, host_s, dev_s, pull_s, push_s, uniq, *_) in \
            runs.items():
        log(f"ps (d): {label} channel [{CARD}]: {n / total:.1f} samples/s, "
            f"pull {pull_s / len(uniq) * 1e3:.2f} ms and push "
            f"{push_s / len(uniq) * 1e3:.2f} ms a step, host "
            f"{host_s / len(uniq) * 1e3:.2f} ms against device "
            f"{dev_s / len(uniq) * 1e3:.2f} ms a step, unique ids a batch "
            f"{min(uniq)}-{max(uniq)} (mean {np.mean(uniq):.0f})")
    log(f"ps (d): Criteo-shaped CTR ({c['dense']} dense + {c['sparse']} "
        f"sparse slots, ids Zipf({c['zipf']}) over 2^24 keys, hashed), "
        f"{c['batches']} batches of {c['batch']} through MultiSlotDataGenerator"
        f" and InMemoryDataset (parse {parse_s:.2f} s on a thread beside "
        f"(e)), one SparseTable of "
        f"dim {c['dim']} (adagrad), DeepFM's 400-400-400 MLP: {len(keys)} "
        f"table rows ({remote_rows} on the RPC server); rows equal over "
        f"both channels: {same}; against the same run on the CPU (the same "
        f"ids: {same_keys}), elements within {PS_ROW_ATOL:g} (at least "
        f"{PS_ROW_SHARE} asked) after the first batch (PsBatch, "
        f"{len(card_snaps[0][0])} rows) {share:.6f}, relative L2 "
        f"{rel:.3e}; after the second (PsEmbedding), in its "
        f"{int(new.sum())} new rows, {share1:.6f}, relative L2 {rel1:.3e} "
        f"(in all {len(card_snaps[1][0])} rows {whole1:.6f}; printed); "
        f"after all {c['batches']}: {end_share:.6f} within, relative L2 "
        f"{end_rel:.3e} (printed), where the CPU on 1 thread against the "
        f"CPU on {threads}: {self_share:.6f} within, relative L2 "
        f"{self_rel:.3e} (printed); the card's pushed gradients against the "
        f"same steps redone on the CPU from the card's MLP and inputs, "
        f"relative L2 (tol {PS_GRAD_RTOL:g}; the planted fault, one "
        f"sample's gradients lost): "
        + ", ".join(f"{k[0]} step {k[1]} "
                    f"({'PsBatch' if k[1] % 2 == 0 else 'PsEmbedding'}) "
                    f"{v[0]:.3e} (float32 against float64 {v[1]:.3e}, "
                    f"fault {v[2]:.3e})" for k, v in steps.items())
        + f"; save/load round trip {io_s:.2f} s, equal: {reloaded} "
        f"({n_fresh} rows)")
    if not (same and same_keys and share >= PS_ROW_SHARE and reloaded
            and len(steps) == 4
            and all(v[0] <= PS_GRAD_RTOL < v[2] for v in steps.values())
            and remote_rows == len(keys) == n_fresh):
        sys.exit("chip_smoke: the parameter server's tables disagree")


def phase26_guards(runner, ids, model, host):
    """(e): (a)'s runner under TrainSupervisor, and the Watchdog."""
    from paddle_tpu_torch.distributed.watchdog import Watchdog
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.resilience.supervisor import (Preempted,
                                                        TrainSupervisor)
    ckpt, raw = {}, []

    def tensors():
        return {f"{g}.{k}": v for g, tree in runner._groups()
                for k, v in tree.items()}

    def save(step):
        ckpt.update({k: v.detach().to("cpu", copy=True)
                     for k, v in tensors().items()})
        ckpt["__step__"] = step

    def load():
        with torch.no_grad():
            for k, v in tensors().items():
                v.copy_(ckpt[k])
        return ckpt["__step__"]

    def step(tok):
        loss = runner.step(tok, tok)
        raw.append(float(loss))
        return loss

    from paddle_tpu_torch.observability.catalog import metric
    obs.enable()
    try:
        skips = metric("train_nonfinite_skips_total").value
        sup = TrainSupervisor(step, save_fn=save, load_fn=load,
                              restore_fn=load, checkpoint_every=1)
        first = sup.step(ids[0])
        kept = {k: v.clone() for k, v in tensors().items()}
        with faults.injected_faults("train.step_nonfinite:1:FaultInjected"):
            skipped = sup.step(ids[1])
        unchanged = all(torch.equal(v, kept[k]) for k, v in tensors().items())
        counted = metric("train_nonfinite_skips_total").value - skips
        del kept
        sup.request_preemption()
        try:
            sup.step(ids[2])
            code = None
        except Preempted as e:
            code = e.code
        for v in tensors().values():
            v.data.zero_()
        resumed = TrainSupervisor(step, load_fn=load)
        start = resumed.resume()
        after = resumed.step(ids[1])
    finally:
        obs.disable()
    fired = []
    dog = Watchdog(timeout=GUARD_TIMEOUT, poll_interval=0.1,
                   on_timeout=lambda w: fired.append(w.step_count))
    with dog:
        with dog.step_guard():
            pass
        with dog.step_guard():
            time.sleep(GUARD_SLEEP)
    log(f"guards (e) [{CARD}]: supervised 1F1B steps: loss {first!r}; the "
        f"injected train.step_nonfinite skipped its step ({skipped}), "
        f"parameters unchanged: {unchanged}, train_nonfinite_skips_total "
        f"+{counted:g}; the preemption saved parameters only and exited "
        f"with code {code}; resume() at step {start}, the next loss "
        f"{after!r} against the uninterrupted run's {raw[1]!r}; the "
        f"Watchdog ({GUARD_TIMEOUT} s) fired on a step that slept "
        f"{GUARD_SLEEP} s: {dog.fired} (after {fired} steps, the stacks on "
        f"stderr)")
    if not (skipped is None and unchanged and counted == 1 and code == 0
            and start == 1 and after == raw[1] and dog.fired
            and fired == [1]):
        sys.exit("chip_smoke: the training guards misbehaved")


def phase_pipeline_ring_moe_ps():
    """Phase 26; returns each kernel's launches on its main paths: the
    pipeline's runs in (a) and the ring's calls in (b), and (b)'s K1 rows
    at the ring's block shape."""
    gc.collect()
    torch.cuda.empty_cache()
    c = CRITEO
    tmp = tempfile.mkdtemp()
    data_path = os.path.join(tmp, "criteo.txt")
    gen_proc = subprocess.Popen(
        [sys.executable, "-c", CRITEO_GEN, data_path,
         str(c["batches"] * c["batch"]), str(c["dense"]), str(c["sparse"]),
         str(c["keys"]), str(c["zipf"])], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        pt.set_flags({"FLAGS_flash_attention_backend": "pallas",
                      "FLAGS_flash_attention_bwd": "pallas"})
        try:
            runner, ids, model, host, launches = phase26_pipeline()
            log(f"phase 26 (a): {time.perf_counter() - t0:.1f} s")
            # the CTR data is read beside (e), which checks behaviour and
            # times nothing; (b) and (c) wait for it, as the reading
            # thread holds the GIL the launching thread needs
            parse = ctr_parse(gen_proc, data_path)
            t1 = time.perf_counter()
            phase26_guards(runner, ids, model, host)
            parse[0].join()
            log(f"phase 26 (e): {time.perf_counter() - t1:.1f} s")
        finally:
            pt.set_flags({"FLAGS_flash_attention_backend": "auto",
                          "FLAGS_flash_attention_bwd": "auto"})
        del runner, ids, model, host
        gc.collect()
        torch.cuda.empty_cache()
        t1 = time.perf_counter()
        ring, rows = phase26_ring()
        launches["flash_fwd"] += ring
        log(f"phase 26 (b): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase26_moe()
        log(f"phase 26 (c): {time.perf_counter() - t1:.1f} s")
        t1 = time.perf_counter()
        phase26_ps(parse)
        log(f"phase 26 (d): {time.perf_counter() - t1:.1f} s")
    finally:
        if gen_proc.poll() is None:
            gen_proc.kill()
            gen_proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, rows


# phase 27: the serving mesh. Phase 9's traffic and knobs (decode_steps 4)
# through one prefill and one decode replica on the one card, with each of
# these pool formats
MESH_FORMATS = ("bf16", "int8", "fp8_e4m3")


def mesh_spec():
    """The JSON recipe of phase 27's engines (mesh/worker.py builds a
    child's engine from it): llama_7b's widths at SERVING_DEPTH layers in
    bf16, weights from seed(0), phase 9's knobs at decode_steps 4, on the
    card."""
    config = dict(vocab_size=32000, hidden_size=4096,
                  intermediate_size=11008, num_hidden_layers=SERVING_DEPTH,
                  num_attention_heads=32, dtype="bfloat16")
    engine = dict(ENGINE, prefill_buckets=list(ENGINE["prefill_buckets"]),
                  decode_steps=4)
    return {"seed": 0, "config": config, "engine": engine, "device": "cuda"}


def mesh_traffic(server, prompts, knobs):
    """Phase 9's traffic through `server`, an engine or a MeshRouter: half
    the requests before the first step, the rest after the third. Returns
    the streams and finish reasons in request order and the host-clock
    wall of the run."""
    half = ENGINE_REQUESTS // 2
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rids = [server.add_request(p, max_new_tokens=ENGINE_NEW, **kw)
            for p, kw in zip(prompts[:half], knobs[:half])]
    steps = 0
    while steps < 3 or server.has_work():
        server.step()
        steps += 1
        if steps == 3:
            rids += [server.add_request(p, max_new_tokens=ENGINE_NEW, **kw)
                     for p, kw in zip(prompts[half:], knobs[half:])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    done = [server.finished[r] for r in rids]
    return ([r.generated for r in done], [r.finish_reason for r in done],
            wall)


def mesh_counts():
    """The mesh's failover, hedge and health counters of the run so far
    (the observability registry, on through phase 27's runs)."""
    reg = obs.get_registry()
    out = {}
    for name in ("mesh_failovers_total", "mesh_hedges_total",
                 "mesh_slow_demotions_total", "mesh_rpc_timeouts_total"):
        fam = reg.get(name)
        if fam is None:
            continue
        for labels, c in fam.children().items():
            if c.value:
                key = name + "".join(f"{{{k}={v}}}" for k, v in labels)
                out[key] = c.value
    return out


def kv_parts(pool):
    return ["k", "v"] + (["k_scale", "v_scale"] if pool.fmt.quantized
                         else [])


class HandoffAudit:
    """Wraps the prefill engine's export_kv, the decode engine's import_kv
    and the router's hand_off_async: times each part of every hand-off
    (the checks off the clock) and holds each record's blocks against the
    prefill pool at export and the decode pool after import."""

    def __init__(self, prefill, decode):
        self.prefill, self.decode = prefill, decode
        self.export_s = self.import_s = self.total_s = self.check_s = 0.0
        self.records = self.bad_export = self.bad_import = 0
        self._sent = {}
        self._export, self._import = prefill.export_kv, decode.import_kv
        self._hand_off = mesh_router.hand_off_async
        prefill.export_kv = self.export_kv
        decode.import_kv = self.import_kv
        mesh_router.hand_off_async = self.hand_off_async

    def close(self):
        mesh_router.hand_off_async = self._hand_off

    def export_kv(self, req, first_tok):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = self._export(req, first_tok)
        t1 = time.perf_counter()
        self.export_s += t1 - t0
        pool = self.prefill.pool
        ids = pool.tables[req.rid][:rec["k"].shape[1]]
        self.bad_export += any(
            not torch.equal(getattr(pool, key)[:, ids].cpu(), rec[key])
            for key in kv_parts(pool))
        self._sent[rec["trace_id"]] = rec
        self.check_s += time.perf_counter() - t1
        return rec

    def import_kv(self, rec):
        t0 = time.perf_counter()
        rid = self._import(rec)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.import_s += t1 - t0
        pool = self.decode.pool
        sent = self._sent.pop(rec["trace_id"])
        ids = pool.tables[rid][:rec["k"].shape[1]]
        self.bad_import += any(
            not torch.equal(getattr(pool, key)[:, ids].cpu(), sent[key])
            for key in kv_parts(pool))
        self.records += 1
        self.check_s += time.perf_counter() - t1
        return rid

    def hand_off_async(self, record, engine, retry=None):
        c0 = self.check_s
        t0 = time.perf_counter()
        fut = self._hand_off(record, engine, retry=retry)
        torch.cuda.synchronize()
        self.total_s += time.perf_counter() - t0 - (self.check_s - c0)
        return fut


def mesh_serve(model, spec, fmt, prompts, knobs, mesh):
    """Phase 9's traffic at pool format `fmt` through a single engine
    over `model`, or (mesh=True) through a MeshRouter over one prefill and
    one decode replica, each an engine over the same model. Returns the
    run's numbers."""
    kw = dict(worker.engine_kwargs(spec), kv_cache_dtype=fmt)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    obs.get_registry().reset()
    obs.enable()
    audit = router = None
    if mesh:
        pool = ReplicaPool(lambda: ContinuousBatchingEngine(model, **kw),
                           n=2, disaggregate=True, store_port=0)
        router = server = MeshRouter(pool)
        audit = HandoffAudit(pool.prefill_targets()[0].engine,
                             pool.decode_targets()[0].engine)
    else:
        server = ContinuousBatchingEngine(model, **kw)
    zero_flash_launches()
    try:
        streams, reasons, wall = mesh_traffic(server, prompts, knobs)
    finally:
        if audit is not None:
            audit.close()
    out = dict(streams=streams, reasons=reasons, wall=wall,
               launches=flash_launches(),
               tokens=sum(map(len, streams)),
               ttft=hist_median("serving_ttft_seconds"),
               tpot=hist_median("serving_tpot_seconds"),
               peak=torch.cuda.max_memory_allocated(), audit=audit,
               counts=mesh_counts())
    if router is not None:
        rep = router.mesh_report()
        out.update(report=rep, alive=len(pool.alive()))
    obs.disable()
    return out


def mesh_check(label, run, want, vocab):
    """Every stream of `run` ended with ENGINE_NEW tokens of the
    vocabulary and equals `want`'s; no K1-K4 launch."""
    if any(len(s) != ENGINE_NEW for s in run["streams"]) or any(
            r != "length" for r in run["reasons"]):
        sys.exit(f"chip_smoke: mesh {label}: a request did not finish with "
                 f"{ENGINE_NEW} tokens")
    if any(t < 0 or t >= vocab for s in run["streams"] for t in s):
        sys.exit(f"chip_smoke: mesh {label}: a token id is out of the "
                 "vocabulary")
    if run["launches"]:
        sys.exit(f"chip_smoke: mesh {label} launched K1-K4 "
                 f"{run['launches']} times")
    if want is not None and run["streams"] != want:
        bad = [i for i, (a, b) in enumerate(zip(run["streams"], want))
               if a != b]
        sys.exit(f"chip_smoke: mesh {label}: streams {bad} differ from the "
                 "single engine's")


def fmt_s(x, digits=4):
    return "not measured" if x is None else f"{x:.{digits}f} s"


def mesh_in_process(model, spec, prompts, knobs):
    """Phase 27 (a): each pool format through a single engine and the
    in-process mesh. Returns the bf16 single engine's streams."""
    vocab = spec["config"]["vocab_size"]
    base = None
    for fmt in MESH_FORMATS:
        one = mesh_serve(model, spec, fmt, prompts, knobs, mesh=False)
        mesh_check(f"{fmt} single engine", one, None, vocab)
        two = mesh_serve(model, spec, fmt, prompts, knobs, mesh=True)
        mesh_check(f"{fmt} mesh", two, one["streams"], vocab)
        a, rep = two["audit"], two["report"]
        nbytes = rep["handoffs"]["bytes"]
        if a.records != ENGINE_REQUESTS or rep["handoffs"]["ok"] \
                != ENGINE_REQUESTS:
            sys.exit(f"chip_smoke: mesh {fmt}: {a.records} blocks imported, "
                     f"{rep['handoffs']} hand-offs for {ENGINE_REQUESTS} "
                     "requests")
        if a.bad_export or a.bad_import:
            sys.exit(f"chip_smoke: mesh {fmt}: {a.bad_export} records differ "
                     f"from the prefill pool at export, {a.bad_import} "
                     "decode pools from the record after import")
        log(f"mesh (a) {fmt} [{CARD}]: single engine {one['tokens']} tokens "
            f"in {one['wall']:.3f} s, {one['tokens'] / one['wall']:.1f} "
            f"tokens/s, TTFT median {fmt_s(one['ttft'])}, TPOT median "
            f"{fmt_s(one['tpot'], 5)}, peak {one['peak'] / 2**30:.2f} GiB")
        log(f"mesh (a) {fmt} [{CARD}]: prefill + decode replica "
            f"{two['tokens']} tokens in {two['wall']:.3f} s, "
            f"{two['tokens'] / two['wall']:.1f} tokens/s (host clock, the "
            f"replicas stepped in turn; sim_parallel_wall "
            f"{rep['sim_parallel_wall_s']} s), TTFT median "
            f"{fmt_s(two['ttft'])}, TPOT median {fmt_s(two['tpot'], 5)}, "
            f"peak {two['peak'] / 2**30:.2f} GiB; streams equal the single "
            f"engine's (12 greedy, 4 sampled)")
        log(f"mesh (a) {fmt} [{CARD}]: hand-off of {a.records} records, "
            f"{nbytes} bytes: {(a.export_s + a.total_s) * 1e3:.1f} ms in "
            f"all ({a.export_s * 1e3:.1f} export read-back, "
            f"{(a.total_s - a.import_s) * 1e3:.1f} pack + unpack, "
            f"{a.import_s * 1e3:.1f} import), "
            f"{nbytes / (a.export_s + a.total_s) / 1e9:.3f} GB/s; every "
            f"block equal at export and after import")
        log(f"mesh (a) {fmt} [{CARD}]: failovers {rep['failovers'] or 'none'}"
            f", slow {rep['slow'] or 'none'}, replicas alive {two['alive']} "
            f"of 2, counters {two['counts'] or 'none'}")
        if fmt == "bf16":
            base = one["streams"]
        del one, two
    return base


def mesh_processes(spec, prompts, knobs, want):
    """Phase 27 (b): the traffic through two child workers on the card
    (one prefill, one decode) built from `spec`."""
    gc.collect()
    torch.cuda.empty_cache()
    obs.get_registry().reset()
    obs.enable()
    t0 = time.perf_counter()
    pool = ProcessReplicaPool(transport="socket", n=2, disaggregate=True,
                              engine_spec=spec, store_port=0)
    spawn_s = time.perf_counter() - t0
    free, total = torch.cuda.mem_get_info()
    log(f"mesh (b) [{CARD}]: 2 workers (pids "
        f"{[rep.proc.pid for rep in pool]}) spawned and built in "
        f"{spawn_s:.1f} s; the card's free memory after the spawn "
        f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB (this process "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB)")
    try:
        router = MeshRouter(pool)
        streams, reasons, wall = mesh_traffic(router, prompts, knobs)
        rep = router.mesh_report()
        alive = len(pool.alive())
    finally:
        pool.close()
    codes = [rep_.proc.wait(timeout=60) for rep_ in pool]
    counts = mesh_counts()
    obs.disable()
    run = dict(streams=streams, reasons=reasons, launches=0)
    mesh_check("process workers", run, want, spec["config"]["vocab_size"])
    tokens = sum(map(len, streams))
    log(f"mesh (b) [{CARD}]: {tokens} tokens in {wall:.3f} s, "
        f"{tokens / wall:.1f} tokens/s (host clock); hand-offs "
        f"{rep['handoffs']}, failovers {rep['failovers'] or 'none'}, slow "
        f"{rep['slow'] or 'none'}, alive {alive} of 2, counters "
        f"{counts or 'none'}; streams equal worker.build_engine(spec)'s; "
        f"workers exited {codes}")
    if not rep["handoffs"]["ok"]:
        sys.exit(f"chip_smoke: mesh (b): no stream was handed off between "
                 f"the workers ({rep['handoffs']})")
    return spawn_s


def mesh_drill_and_loadgen():
    """Phase 27 (c) the chaos drill and (d) loadgen's mesh on the card."""
    from paddle_tpu_torch.tools import autoscale_report, chaos_drill
    from paddle_tpu_torch.tools import loadgen as loadgen_cli
    t0 = time.perf_counter()
    obs.get_registry().reset()
    rows, problems = chaos_drill.run(device="cuda")
    drilled = [(site, out) for site, out, _ in rows if out != "-"]
    escapes = sum(out == "ESCAPED" for _, out in drilled)
    log(f"mesh (c) [{CARD}]: chaos drill on cuda, {len(drilled)} sites "
        f"in {time.perf_counter() - t0:.1f} s, {escapes} escapes: "
        + ", ".join(f"{site} {out}" for site, out in drilled)
        + "; not drilled: " + (", ".join(
            site for site, out, _ in rows if out == "-") or "none"))
    if problems or len(drilled) != 31 or escapes or dict(drilled).get(
            "compile.shard_prop") != "degraded":
        sys.exit("chip_smoke: chaos drill on the card: "
                 + "; ".join(problems or [f"{len(drilled)} sites drilled"]))
    obs.disable()
    obs.get_registry().reset()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mesh_report.json")
        t0 = time.perf_counter()
        rc = loadgen_cli.main(["--scenario", "chat", "--replicas", "2",
                               "--disaggregate", "--check", "--out", path])
        with open(path) as f:
            report = json.load(f)
        mesh = report["mesh"] or {}
        log(f"mesh (d) [{CARD}]: loadgen chat --replicas 2 --disaggregate "
            f"on cuda in {time.perf_counter() - t0:.1f} s: issued "
            f"{report['issued']}, goodput {report['goodput']}, TTFT p95 "
            f"{report['ttft']['p95']} s, TPOT p95 {report['tpot']['p95']} "
            f"s, hand-offs {mesh.get('handoffs')}, check rc {rc}")
        if rc:
            sys.exit("chip_smoke: loadgen --replicas 2 --disaggregate "
                     "--check failed on the card")
        if autoscale_report.main([path, "--check"]):
            sys.exit("chip_smoke: the mesh report's autoscale verdict "
                     "fails its check")
    get_phase_accountant().disable()
    obs.disable()
    obs.get_registry().reset()


def phase_mesh():
    """Phase 27: the serving mesh on the card, (a)-(d)."""
    spec = mesh_spec()
    t0 = time.perf_counter()
    model = worker.build_model(spec)
    torch.cuda.synchronize()
    log(f"mesh [{CARD}]: llama_7b at {SERVING_DEPTH} layers built from the "
        f"worker spec in {time.perf_counter() - t0:.2f} s "
        f"({model.num_params()} params)")
    prompts, knobs = engine_traffic(spec["config"]["vocab_size"])
    # the process's first engine run pays one-time set-up (allocator,
    # library handles) that phase 9 pays before its timed runs: off the
    # clock here, on four short requests
    warm = ContinuousBatchingEngine(model, **worker.engine_kwargs(spec))
    mesh_traffic(warm, [p[:64] for p in prompts[:4]], knobs[:4])
    del warm
    base = mesh_in_process(model, spec, prompts, knobs)
    del model
    zero_flash_launches()
    mesh_processes(spec, prompts, knobs, base)
    mesh_drill_and_loadgen()
    if flash_launches():
        sys.exit(f"chip_smoke: the mesh's workers, drill or loadgen "
                 f"launched K1-K4 {flash_launches()} times in this process")


# -- phase 28: the PIR compile pipeline and jit.to_static ------------------

# (a), (d): llama_1.3b serving a prefill of 4 prompts of 512 tokens
TS_SERVE = dict(b=4, s=512)
# (b): one training step at llama_1.3b's sequence, batch 2 (the router's
# ledger row at 2 x 16 heads and s2048 takes K1 forward, K3/K4 backward)
TS_TRAIN = dict(b=2, s=2048)
TS_LR = 1e-4
# (c): hand-written causal attention at the training attention shape, and
# the unfused rmsnorm(attention + residual) * gamma at the prefill shape
TS_PATTERN = dict(b=8, h=16, s=2048, d=128)
TS_EPILOGUE = dict(b=4, h=16, s=512, d=128)
# (b): the loss relative to its value and each gradient relative to its
# largest magnitude, as phase 5 holds K3/K4: both steps run K1 and K3/K4,
# but CSE merges the three projections' views of each normed input, so
# their gradients are summed in another order in bf16
TS_LOSS_RTOL = 1e-2
TS_GRAD_RTOL = BWD_RTOL


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def ts_counts():
    return {"flash_fwd": fa.flash_fwd_launches,
            "flash_fwd_rms_epilogue": fa.flash_fwd_rms_epilogue_launches,
            "flash_bwd_dq": fa.flash_bwd_dq_launches,
            "flash_bwd_dkv": fa.flash_bwd_dkv_launches}


def ts_report(label, rep):
    """One line of what the pipeline did: stage seconds, ops before and
    after the passes, each pass's edits, patterns, fusion, CostModel."""
    sec = ", ".join(f"{k} {v:.3f}" for k, v in rep.seconds.items())
    edits = ", ".join(f"{k} {v['edits']}" for k, v in
                      rep.pass_report.items())
    cost = rep.cost
    log(f"to_static {label}: seconds ({sec}); ops {rep.captured_ops} -> "
        f"{rep.final_ops}; edits ({edits}); patterns {rep.pattern_counts}; "
        f"fusion groups {rep.fusion_groups} {rep.fusion_kinds}; CostModel "
        f"{cost.flops / 1e12:.4f} TFLOP, {cost.bytes / 1e9:.3f} GB; cache "
        f"{rep.cache}; fallback {rep.fallback}")


def ts_serve(model, device, cache_dir):
    """(a) a to_static prefill of llama_1.3b against eager, and (d) the
    compile cache cold, warm and corrupted. Returns K1's launches of the
    counted call."""
    from paddle_tpu_torch import pir
    cfg = model.config
    b, s = TS_SERVE["b"], TS_SERVE["s"]
    heads, d = cfg.num_attention_heads, cfg.hidden_size // \
        cfg.num_attention_heads
    on_card = torch.device(device).type == "cuda"
    if on_card:
        dec = ar.route(b * heads, s, s, d, torch.bfloat16, True,
                       platform="cuda")
        log(f"to_static (a): router at (bh {b * heads}, s{s}, d{d}, bf16, "
            f"causal): fwd={dec.fwd} [{dec.source}]")
        if dec.fwd != "pallas":
            sys.exit("chip_smoke: the router does not send llama_1.3b's "
                     "prefill attention to K1")
    ids = torch.as_tensor(np.random.RandomState(28).randint(
        0, cfg.vocab_size, (b, s)), device=device)
    with torch.no_grad():
        eager = model(ids)
    sf = jit.to_static(model.forward)
    t0 = time.perf_counter()
    with torch.no_grad():
        cold = sf(ids)
    sync(device)
    cold_s = time.perf_counter() - t0
    rep = sf.last_report
    ts_report("(a) prefill", rep)
    if rep.fallback is not None or rep.cache != "miss":
        sys.exit(f"chip_smoke: to_static prefill: fallback {rep.fallback}, "
                 f"cache {rep.cache}")
    zero_flash_launches()                    # the served call starts here
    with torch.no_grad():
        out = sf(ids)
    sync(device)
    launches = ts_counts()["flash_fwd"]      # and ends here
    times = {"eager": [], "to_static": []}
    with torch.no_grad():
        for fn, key in ((model.forward, "eager"), (sf, "to_static"),
                        (sf, "to_static"), (model.forward, "eager"),
                        (model.forward, "eager"), (sf, "to_static")):
            t0 = time.perf_counter()
            fn(ids)
            sync(device)
            times[key].append((time.perf_counter() - t0) * 1e3)
    static_ms = statistics.median(times["to_static"])
    eager_ms = statistics.median(times["eager"])
    want = cfg.num_hidden_layers if on_card else 0
    err = ((out.float() - eager.float()).abs().max()
           / eager.float().abs().max()).item()
    log(f"to_static (a) [{CARD}]: logits {tuple(out.shape)}, max error "
        f"{err:.3e} of the largest logit (bit for bit: "
        f"{torch.equal(out, eager)}), K1 launches {launches} a call; "
        f"call median {static_ms:.1f} ms against eager {eager_ms:.1f} ms "
        f"(3 each, interleaved); "
        f"first call (capture, passes, cache write, run) {cold_s:.2f} s")
    # the program replays eager's ops in eager's order under no_grad (the
    # passes merge, fold and regroup but do not reorder a sum), so its
    # logits equal eager's bit for bit
    if launches != want or not torch.equal(out, eager) \
            or not torch.isfinite(out).all():
        sys.exit(f"chip_smoke: to_static prefill: {launches} K1 launches "
                 f"(expected {want}), logits error {err:.3e}, not equal "
                 f"to eager's")
    if not torch.equal(cold, out):
        sys.exit("chip_smoke: two to_static calls disagree")

    # (d) the same program warm from a new StaticFunction, then corrupted
    t0 = time.perf_counter()
    warm_sf = jit.to_static(model.forward)
    with torch.no_grad():
        warm = warm_sf(ids)
    sync(device)
    warm_s = time.perf_counter() - t0
    wrep = warm_sf.last_report
    log(f"to_static (d) [{CARD}]: cold first call {cold_s:.2f} s (cache "
        f"{rep.cache}), warm {warm_s:.2f} s (cache {wrep.cache}; stage "
        f"seconds {({k: round(v, 3) for k, v in wrep.seconds.items()})}), "
        f"artifact {os.path.getsize(os.path.join(cache_dir, rep.key + '.pirc'))} "
        f"bytes, bit for bit: {torch.equal(warm, cold)}")
    if wrep.cache != "hit" or not torch.equal(warm, cold):
        sys.exit(f"chip_smoke: warm to_static: cache {wrep.cache}, "
                 f"equal {torch.equal(warm, cold)}")
    path = os.path.join(cache_dir, rep.key + ".pirc")
    blob = bytearray(Path(path).read_bytes())
    blob[len(blob) // 2] ^= 0xFF
    Path(path).write_bytes(bytes(blob))
    try:
        pir.CompileCache(cache_dir).get(rep.key)
        sys.exit("chip_smoke: a corrupted artifact read back")
    except pir.CompileCacheCorruptionError as e:
        typed = type(e).__name__
    obs.get_registry().reset()
    obs.enable()
    try:
        import warnings
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            again_sf = jit.to_static(model.forward)
            with torch.no_grad():
                again = again_sf(ids)
        corrupt = obs.get_registry().get("compile_cache_corrupt_total").value
        arep = again_sf.last_report
        log(f"to_static (d): flipped byte -> {typed}, "
            f"compile_cache_corrupt_total {corrupt}, recompile cache "
            f"{arep.cache}, equal to cold {torch.equal(again, cold)}")
        if corrupt != 1 or arep.cache != "miss" or arep.fallback \
                or not torch.equal(again, cold):
            sys.exit("chip_smoke: the corrupted artifact was not caught, "
                     "counted and recompiled")
    finally:
        obs.disable()
        obs.get_registry().reset()
    return launches


def ts_train(model, device):
    """(b) one training step through a to_static forward and
    loss.backward(), then AdamW, against the eager step. Returns the
    step's launches."""
    cfg = model.config
    b, s = TS_TRAIN["b"], TS_TRAIN["s"]
    on_card = torch.device(device).type == "cuda"
    model.train()
    ids = torch.as_tensor(np.random.RandomState(29).randint(
        0, cfg.vocab_size, (b, s)), device=device)
    model.zero_grad(set_to_none=True)
    loss_e, _ = model(ids, labels=ids)
    loss_e.backward()
    want = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    sf = jit.to_static(model.forward)
    zero_flash_launches()                    # the to_static step starts here
    loss, _ = sf(ids, labels=ids)
    loss.backward()
    sync(device)
    counts = ts_counts()                     # and ends here
    ts_report("(b) training forward", sf.last_report)
    if sf.last_report.fallback is not None:
        sys.exit(f"chip_smoke: to_static training step fell back at "
                 f"{sf.last_report.fallback}")
    loss_err = abs(loss.item() - loss_e.item()) / abs(loss_e.item())
    worst, worst_k = 0.0, None
    for k, p in model.named_parameters():
        g = p.grad.float()
        e = (g - want[k].float()).abs().max() / \
            want[k].float().abs().max().clamp_min(1e-30)
        if e.item() > worst:
            worst, worst_k = e.item(), k
    n = cfg.num_hidden_layers if on_card else 0
    expect = {"flash_fwd": n, "flash_fwd_rms_epilogue": 0,
              "flash_bwd_dq": n, "flash_bwd_dkv": n}
    log(f"to_static (b) [{CARD}]: loss {loss.item():.6f} against eager "
        f"{loss_e.item():.6f} (rel {loss_err:.2e}); worst gradient error "
        f"{worst:.3e} of its largest magnitude ({worst_k}); launches "
        f"{counts}")
    if counts != expect or loss_err > TS_LOSS_RTOL or worst > TS_GRAD_RTOL:
        sys.exit(f"chip_smoke: to_static training step: launches {counts} "
                 f"(expected {expect}), loss error {loss_err:.3e}, gradient "
                 f"error {worst:.3e}")
    opt = optimizer.AdamW(TS_LR, parameters=model.parameters())
    opt.step()
    if not all(torch.isfinite(p).all() for p in model.parameters()):
        sys.exit("chip_smoke: a parameter is not finite after AdamW")

    def step(fn):
        opt.clear_grad()
        loss, _ = fn(ids, labels=ids)
        loss.backward()
        opt.step()
        sync(device)

    times = {"eager": [], "to_static": []}
    for fn, key in ((model.forward, "eager"), (sf, "to_static"),
                    (sf, "to_static"), (model.forward, "eager"),
                    (model.forward, "eager"), (sf, "to_static")):
        t0 = time.perf_counter()
        step(fn)
        times[key].append((time.perf_counter() - t0) * 1e3)
    log(f"to_static (b) [{CARD}]: llama_1.3b step (b{b} s{s}, forward, "
        f"backward, AdamW) median {statistics.median(times['to_static']):.1f}"
        f" ms through to_static against {statistics.median(times['eager']):.1f}"
        f" ms eager (3 each, interleaved)")
    model.eval()
    opt.clear_grad()
    return counts


def dense_causal_attention(q, k, v):
    """Attention written out densely: f32 scores, the -1e30 causal mask,
    softmax, P in v's dtype, P V."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        / q.shape[-1] ** 0.5
    keep = torch.ones(q.shape[1], k.shape[1], dtype=torch.bool,
                      device=q.device).tril()
    p = torch.softmax(s.masked_fill(~keep, -1e30), dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def unfused_rms_epilogue(q, k, v, res, w):
    att = dense_causal_attention(q, k, v)
    hh = (att + res).float()
    ms = torch.mean(hh * hh, dim=-1, keepdim=True)
    return ((hh * torch.rsqrt(ms + RMS_EPS) * w.float()).to(att.dtype),)


def ts_patterns(device):
    """(c) the dense attention becomes one pt.sdpa launching K1, the
    unfused epilogue one pt.sdpa_rms_epilogue launching K2. Returns their
    launches."""
    from paddle_tpu_torch import pir
    on_card = torch.device(device).type == "cuda"
    gen = torch.Generator(device=device).manual_seed(30)
    b, h, s, d = (TS_PATTERN[k] for k in "bhsd")
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device=device)
               .to(torch.bfloat16) for _ in range(3))
    compiled, rep = pir.compile_flat(
        lambda q_, k_, v_: (dense_causal_attention(q_, k_, v_),),
        [q, k, v], name="dense_attention")
    ts_report("(c) dense attention", rep)
    sdpa = [op for op in rep.program.ops if op.name == "pt.sdpa"]
    zero_flash_launches()                    # the rewritten call
    with torch.no_grad():
        out = compiled(q, k, v)[0]
    sync(device)
    k1 = ts_counts()["flash_fwd"]
    with torch.no_grad():
        want = dense_causal_attention(q, k, v)
        times = ""
        if on_card:
            times = (f"; {time_ms(lambda: compiled(q, k, v)):.4f} ms a "
                     f"call against the dense version's "
                     f"{time_ms(lambda: dense_causal_attention(q, k, v), reps=5):.4f}"
                     f" (medians on CUDA events)")
    err = (out.float() - want.float()).abs().max().item()
    log(f"to_static (c) [{CARD}]: dense attention b{b} h{h} s{s} d{d} -> "
        f"{[op.name for op in rep.program.ops]} (route "
        f"{sdpa[0].attrs['route_fwd'] if sdpa else None}), K1 launches "
        f"{k1}, max error {err:.3e} against the dense eager version{times}")
    if rep.fallback or len(sdpa) != 1 or k1 != (1 if on_card else 0) \
            or not torch.allclose(out.float(), want.float(), atol=OUT_ATOL,
                                  rtol=OUT_RTOL):
        sys.exit("chip_smoke: the sdpa pattern did not route the dense "
                 "attention to K1 within tolerance")
    del q, k, v, out, want, compiled, rep, sdpa
    gc.collect()
    b, h, s, d = (TS_EPILOGUE[k] for k in "bhsd")
    q, k, v, res = (torch.randn(b, s, h, d, generator=gen, device=device)
                    .to(torch.bfloat16) for _ in range(4))
    w = torch.rand(d, generator=gen, device=device) + 0.5
    compiled, rep = pir.compile_flat(unfused_rms_epilogue,
                                     [q, k, v, res, w], name="epilogue")
    ts_report("(c) unfused epilogue", rep)
    epi = [op for op in rep.program.ops if op.name == "pt.sdpa_rms_epilogue"]
    zero_flash_launches()
    with torch.no_grad():
        out = compiled(q, k, v, res, w)[0]
    sync(device)
    k2 = ts_counts()["flash_fwd_rms_epilogue"]
    with torch.no_grad():
        want = unfused_rms_epilogue(q, k, v, res, w)[0]
    diff = (out.float() - want.float()).abs()
    bound = K2_ATOL * w.abs().max() + K2_RTOL * want.float().abs()
    log(f"to_static (c) [{CARD}]: unfused epilogue b{b} h{h} s{s} d{d} -> "
        f"{[op.name for op in rep.program.ops]} (route "
        f"{epi[0].attrs['route_fwd'] if epi else None} "
        f"[{epi[0].attrs['route_source'] if epi else None}]), K2 launches "
        f"{k2}, max error {diff.max().item():.3e}")
    if rep.fallback or len(epi) != 1 or k2 != (1 if on_card else 0) \
            or not bool((diff <= bound).all()):
        sys.exit("chip_smoke: the rms-epilogue pattern did not route the "
                 "unfused epilogue to K2 within tolerance")
    return {"flash_fwd": k1, "flash_fwd_rms_epilogue": k2}


def ts_graph_break(device):
    """(e) a function with one data-dependent branch: 2 segments, equal to
    eager, with gradients."""
    import warnings

    def fn(x, w):
        h = torch.tanh(x @ w) * 2.0
        if float(h.sum()) > -1e9:            # the graph break
            return (h * h).sum() / h.numel()
        return h.sum()

    gen = torch.Generator(device=device).manual_seed(31)
    x = torch.randn(1024, 1024, generator=gen, device=device)
    w1 = (torch.randn(1024, 1024, generator=gen, device=device) * 0.03) \
        .requires_grad_()
    w2 = w1.detach().clone().requires_grad_()
    sf = jit.to_static(fn)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        y = sf(x, w1)
    y.backward()
    want = fn(x, w2)
    want.backward()
    sync(device)
    gerr = ((w1.grad - w2.grad).abs().max()
            / w2.grad.abs().max()).item()
    log(f"to_static (e) [{CARD}]: graph break -> {sf._last_segments} "
        f"segments, value {y.item():.6f} against eager {want.item():.6f}, "
        f"gradient error {gerr:.3e} of its largest magnitude")
    if sf._last_segments != 2 or not math.isclose(y.item(), want.item(),
                                                  rel_tol=1e-5) \
            or gerr > 1e-5:
        sys.exit("chip_smoke: the staged graph break disagrees with eager")


def ts_pipeline_tax(device, captures):
    """(f) tools/pipeline_tax.py at its tiny config; its flops captures
    (host time only, in worker processes) started with (e)."""
    from paddle_tpu_torch.tools import pipeline_tax
    t0 = time.perf_counter()
    rows, failures = pipeline_tax.run(device, captures=captures)
    log(f"to_static (f) [{CARD}]: pipeline_tax in "
        f"{time.perf_counter() - t0:.1f} s:\n"
        + pipeline_tax.table(rows, device))
    if failures or any(r[3] is None for r in rows):
        sys.exit("chip_smoke: pipeline_tax: " + "; ".join(
            failures or ["a CostModel capture failed"]))


def phase_to_static(device="cuda", cfg=None):
    """Phase 28; returns each kernel's launches over (a)-(c)'s counted
    runs."""
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    name, lcfg, *_ = train_llama.llama_ladder()[0]
    return ts_phase(name, cfg or lcfg, device)


def ts_phase(name, cfg, device):
    """Phase 28 (a)-(f) on `cfg`'s llama. (f)'s CostModel captures (host
    time only) run in worker processes on the host's other cores from the
    start of (e), after (a)-(c)'s host-clock timings."""
    from paddle_tpu_torch.framework import flags as _flags
    from paddle_tpu_torch.tools import pipeline_tax
    t0 = time.perf_counter()
    pt.seed(0)
    model = pt.models.LlamaForCausalLM(cfg, device=device).eval()
    log(f"to_static: {name} ({cfg.num_hidden_layers} layers, hidden "
        f"{cfg.hidden_size}, {cfg.num_attention_heads} heads, {cfg.dtype}) "
        f"built in {time.perf_counter() - t0:.2f} s")
    prev = _flags.flag_value("compile_cache_dir")
    with tempfile.TemporaryDirectory() as tmp:
        cache_dir = os.path.join(tmp, "pirc")
        _flags.set_flags({"compile_cache_dir": cache_dir})
        try:
            t0 = time.perf_counter()
            served = ts_serve(model, device, cache_dir)
            log(f"phase 28 (a), (d): {time.perf_counter() - t0:.1f} s")
        finally:
            _flags.set_flags({"compile_cache_dir": prev})
    t0 = time.perf_counter()
    trained = ts_train(model, device)
    log(f"phase 28 (b): {time.perf_counter() - t0:.1f} s")
    del model
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pattern = ts_patterns(device)
    log(f"phase 28 (c): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    captures = pipeline_tax.FlopsCaptures()
    try:
        ts_graph_break(device)
        ts_pipeline_tax(device, captures)
    finally:
        captures.close()
    log(f"phase 28 (e), (f): {time.perf_counter() - t0:.1f} s")
    return {"flash_fwd": served + trained["flash_fwd"]
            + pattern["flash_fwd"],
            "flash_fwd_rms_epilogue": pattern["flash_fwd_rms_epilogue"],
            "flash_bwd_dq": trained["flash_bwd_dq"],
            "flash_bwd_dkv": trained["flash_bwd_dkv"]}


# --------------------------------------------------------------------------
# phase 29: the PIR sharding passes (pir/shard_prop.py, shard_search.py,
# overlap.py, ops/collectives.py) and the engine through pir_jit
# --------------------------------------------------------------------------

# (c): the overlap program's widths, where the compute in the all-reduce's
# window can hide it: x [M, K] @ w [K, N] reduced, y [N, N] products beside
OVERLAP = dict(m=4096, k=8192, n=4096)
# (d), (e): the greedy requests of phase 9's traffic the engines serve
SHARD_SERVE = 4


def shard_mesh(device):
    from paddle_tpu_torch.distributed import ProcessMesh
    return ProcessMesh([[0, 1], [2, 3]], ["dp", "mp"], device=device)


def shard_step(model):
    """The training step's forward as a function of the parameters: what
    pir_jit compiles and its sharding rules match by path."""
    def step(params, ids):
        return torch.func.functional_call(model, params, (ids,),
                                          {"labels": ids})[0]
    return step


def shard_notes(rep, name):
    """{key: value} of a pass's report notes ("values=3 rules=1")."""
    return dict(p.split("=", 1) for p in
                rep.pass_report[name]["notes"].split() if "=" in p)


def phase_sharding(device="cuda", cfg=None):
    """Phase 29 (a)-(c); returns (a)-(b)'s kernel launches."""
    from paddle_tpu_torch.pir import shard_prop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    name, lcfg, *_ = train_llama.llama_ladder()[0]
    cfg = cfg or lcfg
    pt.seed(0)
    model = pt.models.LlamaForCausalLM(cfg, device=device).train()
    ids = torch.as_tensor(np.random.RandomState(29).randint(
        0, cfg.vocab_size, (TS_TRAIN["b"], TS_TRAIN["s"])), device=device)
    mesh = shard_mesh(device)
    t0 = time.perf_counter()
    a = shard_train(model, ids, mesh, device, name)
    log(f"phase 29 (a): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    b = shard_search(model, ids, mesh, device, a)
    log(f"phase 29 (b): {time.perf_counter() - t0:.1f} s")
    del model, a
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    shard_overlap(device)
    log(f"phase 29 (c): {time.perf_counter() - t0:.1f} s")
    assert shard_prop.current_mesh() is None
    return b


def shard_train(model, ids, mesh, device, name):
    """(a) the training step through pir_jit(sharding_rules=
    LLAMA_SHARDING_RULES) under the 2x2 logical mesh, against the same
    step compiled outside the scope: the loss and every gradient bit for
    bit, the same K1/K3/K4 launches; the call's ms beside (the replay
    hint's host cost)."""
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.pir import pir_jit, shard_prop
    params = dict(model.named_parameters())
    step = shard_step(model)
    runs = {}
    for label, scope in (("unscoped", None), ("scoped", mesh)):
        fn = pir_jit(step, name="shard_step",
                     sharding_rules=spmd.LLAMA_SHARDING_RULES)
        with shard_prop.mesh_scope(scope):
            sync(device)
            zero_flash_launches()
            t0 = time.perf_counter()
            loss = fn(params, ids)
            grads = torch.autograd.grad(loss, list(params.values()))
            sync(device)
            first = time.perf_counter() - t0
            counts = ts_counts()
        runs[label] = dict(fn=fn, loss=loss.detach(), grads=grads,
                           counts=counts, first=first)
    u, sc = runs["unscoped"], runs["scoped"]
    rep = sc["fn"].report
    notes = shard_notes(rep, "shard_prop")
    equal = torch.equal(u["loss"], sc["loss"]) and all(
        torch.equal(x, y) for x, y in zip(u["grads"], sc["grads"]))
    n_rules = sum("sharding_rule" in op.attrs for op in rep.program.ops)
    times = {"unscoped": [], "scoped": []}
    with torch.no_grad():
        for label in ("unscoped", "scoped", "scoped", "unscoped",
                      "unscoped", "scoped"):
            sync(device)
            t0 = time.perf_counter()
            runs[label]["fn"](params, ids)
            sync(device)
            times[label].append((time.perf_counter() - t0) * 1e3)
    ms = {k: statistics.median(v) for k, v in times.items()}
    n = model.config.num_hidden_layers if device != "cpu" else 0
    expect = {"flash_fwd": n, "flash_fwd_rms_epilogue": 0,
              "flash_bwd_dq": n, "flash_bwd_dkv": n}
    log(f"sharding (a) [{CARD}]: {name} (b{TS_TRAIN['b']} s{TS_TRAIN['s']}, "
        f"{model.config.num_hidden_layers} layers) through "
        f"pir_jit(sharding_rules=LLAMA_SHARDING_RULES) under the 2x2 "
        f"logical mesh: {len(rep.program.inputs)} inputs, values annotated "
        f"{notes.get('values')}, rules stamped {notes.get('rules')} "
        f"({n_rules} ops carry one), conflicts resolved "
        f"{notes.get('resolved')}, sweeps {notes.get('sweeps')}, shard_prop "
        f"{rep.pass_report['shard_prop']['seconds']:.3f} s; loss "
        f"{sc['loss'].item():.6f}, loss and every gradient equal to the "
        f"unscoped compile's: {equal}; launches {sc['counts']} (unscoped "
        f"{u['counts']}); first call with its compile and backward "
        f"{sc['first']:.2f} s (unscoped {u['first']:.2f}); the call "
        f"{ms['scoped']:.1f} ms against the unscoped compile's "
        f"{ms['unscoped']:.1f} ms (medians of 3 interleaved, host clock, "
        f"printed)")
    if not equal or sc["counts"] != u["counts"] or sc["counts"] != expect \
            or rep.fallback is not None or u["fn"].report.fallback \
            or int(notes.get("values", 0)) == 0:
        sys.exit(f"chip_smoke: sharded training step: equal {equal}, "
                 f"launches {sc['counts']} / {u['counts']} (expected "
                 f"{expect}), fallback {rep.fallback}, notes {notes}")
    return {"loss": u["loss"], "counts": {k: sc["counts"][k] + u["counts"][k]
                                          for k in expect}}


def shard_search(model, ids, mesh, device, a):
    """(b) the same step's forward under a search scope of dp, tp and dp+tp
    built from the rule tables, without input shardings: the decision and
    every candidate's predicted seconds on the H100 rows; the loss equal
    to the unscoped step's. Returns (a) and (b)'s launches."""
    from paddle_tpu_torch.distributed.placement import P
    from paddle_tpu_torch.parallel import spmd
    from paddle_tpu_torch.pir import pir_jit, shard_prop
    params = dict(model.named_parameters())
    args = (params, ids)

    def space(table, ids_spec):
        return shard_prop.flat_input_specs(args, [(r"^1$", ids_spec)]
                                           + table)
    search = [("dp", space(spmd.DP_ONLY_RULES, P("dp", None))),
              ("tp", space(spmd.LLAMA_SHARDING_RULES, P())),
              ("dp+tp", space(spmd.LLAMA_SHARDING_RULES, P("dp", None)))]
    fn = pir_jit(shard_step(model), name="shard_search_step")
    with shard_prop.mesh_scope(mesh, search=search), torch.no_grad():
        zero_flash_launches()
        loss = fn(params, ids)
        sync(device)
        counts = ts_counts()
    rep = fn.report
    found = rep.program._shard_search if rep.program is not None else {}
    cands = found.get("candidates", {})
    equal = torch.equal(loss, a["loss"])
    log(f"sharding (b) [{CARD}]: search over {sorted(cands)}: decision "
        f"{rep.shard_decision}, predicted "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                    sorted(cands.items(), key=lambda kv: kv[1]))
        + f" (H100 rows: 989 TFLOP/s, 3.35 TB/s, NVLink 450 GB/s a way, "
        f"data-sheet figures); the search "
        f"{rep.pass_report['shard_search']['seconds']:.3f} s; loss "
        f"equal to the unscoped step's: {equal}; launches {counts}")
    if rep.fallback is not None or rep.shard_decision is None \
            or len(cands) != 4 or not equal:
        sys.exit(f"chip_smoke: sharding search: fallback {rep.fallback}, "
                 f"decision {rep.shard_decision}, candidates {cands}, "
                 f"equal {equal}")
    return {k: a["counts"][k] + counts[k] for k in counts}


def shard_overlap(device):
    """(c) the overlap program over a one-rank NCCL group: the all-reduce
    of a partial product captured after two independent products is
    hoisted; prints comm and exposed seconds before and after and the
    edits, holds the compiled program to eager bit for bit, and prints the
    device time of the captured and the reordered replay."""
    import torch.distributed as tdist
    from paddle_tpu_torch import pir
    from paddle_tpu_torch.pir.analysis import CostModel
    from paddle_tpu_torch.pir.overlap import CollectiveOverlap
    cuda = torch.device(device).type == "cuda"
    tdist.init_process_group("nccl" if cuda else "gloo",
                             init_method=f"tcp://127.0.0.1:{free_port()}",
                             world_size=1, rank=0)
    try:
        group = tdist.group.WORLD.group_name
        F = torch.ops._c10d_functional

        def f(x, w, y):
            p = x @ w
            b = torch.tanh(y) @ y.T
            c = torch.sin(y) @ y
            a = F.wait_tensor(F.all_reduce(p, "sum", group))
            return (a * 2.0 + b + c,)
        m, k, n = OVERLAP["m"], OVERLAP["k"], OVERLAP["n"]
        g = torch.Generator(device).manual_seed(29)
        dtype = torch.bfloat16 if cuda else torch.float32
        x, w, y = (torch.randn(*s, device=device, dtype=dtype, generator=g)
                   * 0.02 for s in ((m, k), (k, n), (n, n)))
        captured, _ = pir.capture(f, x, w, y, name="overlap_captured")
        hoisted, _ = pir.capture(f, x, w, y, name="overlap_hoisted")
        cm = CostModel()
        before = cm.exposed_comm_seconds(captured)
        res = CollectiveOverlap(cm).run(hoisted)
        after = cm.exposed_comm_seconds(hoisted)
        fn, rep = pir.compile_flat(f, [x, w, y], name="overlap")
        out, want = fn(x, w, y)[0], f(x, w, y)[0]
        sync(device)
        equal = torch.equal(out, want) and torch.equal(
            hoisted.bind(x, w, y)[0], want)
        dev_ms = {}
        if cuda:
            for label in ("captured", "hoisted", "hoisted", "captured"):
                prog = captured if label == "captured" else hoisted
                dev_ms.setdefault(label, []).append(
                    profile_serving.median_ms(lambda: prog.bind(x, w, y),
                                              lambda: None))
        order = [op.target.overloadpacket.__name__ if op.target is not None
                 else op.name for op in hoisted.ops]
        log(f"sharding (c) [{CARD}]: x {m}x{k} @ w {k}x{n} all-reduced "
            f"over a one-rank NCCL group after tanh(y) @ y.T and sin(y) @ y"
            f" (y {n}x{n}, {str(dtype).removeprefix('torch.')}): comm "
            f"{before['comm_seconds'] * 1e3:.4f} ms on the NVLink row, "
            f"exposed {before['exposed_seconds'] * 1e3:.4f} -> "
            f"{after['exposed_seconds'] * 1e3:.4f} ms, {res.edits} edit(s) "
            f"(the pipeline's overlap pass: "
            f"{rep.pass_report['overlap']['notes']}); order "
            f"{order}; equal to eager bit for bit: {equal}; device time a "
            f"replay (CUDA events, medians of 5, twice each in turns, "
            f"printed): "
            + ("; ".join(f"{k} {v[0]:.3f} and {v[1]:.3f} ms"
                         for k, v in dev_ms.items()) if dev_ms else
               "not measured")
            + " (one rank moves no bytes, so no overlap can show on one "
            "card)")
        if res.edits < 1 or not after["exposed_seconds"] < \
                before["exposed_seconds"] or not equal \
                or rep.fallback is not None \
                or rep.pass_report["overlap"]["edits"] < 1:
            sys.exit(f"chip_smoke: overlap: edits {res.edits}, exposed "
                     f"{before} -> {after}, equal {equal}, fallback "
                     f"{rep.fallback}")
    finally:
        tdist.destroy_process_group()


def phase_engine_pir(model, streams9):
    """Phase 29 (d) phase 9's engine (llama_7b at SERVING_DEPTH, phase 9's
    knobs) serving SHARD_SERVE of its greedy requests through pir_jit on a
    fresh compile cache, again on the same cache, and with FLAGS_pir off;
    (e) two-replica ReplicaPools, tp=False and tp=True. Returns the K1
    launches of (d)'s runs."""
    from paddle_tpu_torch.framework import flags as _flags
    cfg = model.config
    prompts, knobs = engine_traffic(cfg.vocab_size)
    sel = [i for i in range(ENGINE_REQUESTS) if not knobs[i]][:SHARD_SERVE]
    runs = {}
    prev = (_flags.flag_value("compile_cache_dir"), _flags.flag_value("pir"))
    with tempfile.TemporaryDirectory() as tmp:
        _flags.set_flags({"compile_cache_dir": os.path.join(tmp, "pirc")})
        try:
            for label, on in (("cold", True), ("warm", True),
                              ("as written", False)):
                _flags.set_flags({"pir": on})
                gc.collect()
                torch.cuda.empty_cache()
                eng = ContinuousBatchingEngine(model, **ENGINE)
                rids = [eng.add_request(prompts[i], max_new_tokens=ENGINE_NEW)
                        for i in sel]
                torch.cuda.synchronize()
                zero_flash_launches()
                t0 = time.perf_counter()
                eng.step()
                torch.cuda.synchronize()
                first = time.perf_counter() - t0
                out = eng.run()
                torch.cuda.synchronize()
                runs[label] = dict(
                    streams=[out[r] for r in rids], first=first,
                    wall=time.perf_counter() - t0, launches=flash_launches(),
                    reports={k: (r.cache, r.seconds.get("capture", 0.0),
                                 sum(r.seconds.values()))
                             for k, r in eng.compile_reports.items()})
                if label == "warm":
                    width = max(eng._chunk_widths)
                    prog = eng._compiled(("prefill", width),
                                         f"serving.prefill.b{width}",
                                         eng._prefill_layer, donate=False)
                    chunk_pir, tile_ms = engine_device_ms(eng, layer=prog)
                    chunk_eager, _ = engine_device_ms(eng)
                del eng
        finally:
            _flags.set_flags({"compile_cache_dir": prev[0], "pir": prev[1]})
    want = [streams9[i] for i in sel]
    same = all(r["streams"] == want for r in runs.values())
    caches = {k: {p: c for p, (c, _, _) in r["reports"].items()}
              for k, r in runs.items()}
    log(f"engine pir (d) [{CARD}]: {len(sel)} greedy requests of phase 9's "
        f"(prompts {[len(prompts[i]) for i in sel]}, {ENGINE_NEW} new) at "
        f"its knobs: caches " + "; ".join(
            f"{k}: " + ", ".join(f"{p} {c}" for p, c in sorted(v.items()))
            for k, v in caches.items())
        + "; capture / compile seconds (cold) " + ", ".join(
            f"{p} {cap:.2f} / {tot:.2f}" for p, (_, cap, tot) in
            sorted(runs["cold"]["reports"].items()))
        + "; (warm) " + ", ".join(
            f"{p} {cap:.2f} / {tot:.2f}" for p, (_, cap, tot) in
            sorted(runs["warm"]["reports"].items()))
        + f"; first step {runs['cold']['first']:.2f} s cold, "
        f"{runs['warm']['first']:.2f} s warm, "
        f"{runs['as written']['first']:.2f} s with FLAGS_pir off; runs "
        + ", ".join(f"{k} {r['wall']:.2f} s" for k, r in runs.items())
        + f"; streams equal to phase 9's in all three: {same}")
    log(f"engine pir (d) [{CARD}]: prefill chunk of 512 tokens "
        f"{chunk_pir:.3f} ms compiled, {chunk_eager:.3f} ms as written "
        f"(phase 9: {PHASE9.get('chunk_ms', float('nan')):.3f}); decode "
        f"tile K={ENGINE.get('decode_steps', 4)} {tile_ms['greedy']:.3f} ms "
        f"greedy, {tile_ms['sampled']:.3f} sampled (phase 9: "
        f"{PHASE9.get('tile_ms', {}).get('greedy', float('nan')):.3f}, "
        f"{PHASE9.get('tile_ms', {}).get('sampled', float('nan')):.3f}; "
        f"CUDA events, medians of 5); K1-K4 launches "
        + ", ".join(f"{k} {r['launches']}" for k, r in runs.items())
        + f" (phase 9 run 1: {PHASE9.get('launches')})")
    cold = caches["cold"]
    if not same or cold.get("prefill.b512", cold.get(
            f"prefill.b{ENGINE['prefill_buckets'][0]}")) is None \
            or any(c not in ("miss", "bypass:donate")
                   for c in cold.values()) \
            or cold.get("decode") != "bypass:donate" \
            or not any(c == "hit" for c in caches["warm"].values()) \
            or any(r["launches"] for r in runs.values()):
        sys.exit(f"chip_smoke: the engine through pir_jit: streams equal "
                 f"{same}, caches {caches}")
    shard_replicas(model, prompts, sel)
    return sum(r["launches"] for r in runs.values())


def shard_replicas(model, prompts, sel):
    """(e) two-replica ReplicaPools over the model, tp=False then tp=True:
    the same greedy streams; each tp engine's programs compiled with
    shard_prop declining (the scope closes before the lazy compiles, as
    in the reference)."""
    got, notes = {}, set()
    t0 = time.perf_counter()
    for tp in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        pool = ReplicaPool(lambda: ContinuousBatchingEngine(
            model, **dict(ENGINE, num_blocks=256)), n=2, tp=tp, store_port=0)
        router = MeshRouter(pool)
        rids = [router.add_request(prompts[i], max_new_tokens=16)
                for i in sel]
        out = router.run()
        got[tp] = [out[r] for r in rids]
        if tp:
            notes = {r.pass_report["shard_prop"]["notes"]
                     for rep in pool.replicas
                     for r in rep.engine.compile_reports.values()}
        del pool, router
    log(f"engine pir (e) [{CARD}]: ReplicaPool(n=2, tp=True) against "
        f"tp=False over {len(sel)} greedy requests (16 new each): streams "
        f"equal {got[True] == got[False]}; the tp engines' shard_prop "
        f"{sorted(notes)}; {time.perf_counter() - t0:.1f} s")
    if got[True] != got[False] or notes != {"no-annotations"}:
        sys.exit("chip_smoke: tp replicas serve other tokens than plain ones")


def timed(label, fn, *args):
    """fn(*args), logging its seconds as phase `label`'s."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s")
    return out


def cut_depth(model, layers):
    """llama_7b at its full width and its first `layers` layers (the rest
    freed): the engine, knob and predictor phases' model."""
    full = model.config.num_hidden_layers
    model.llama.layers = model.llama.layers[:layers]
    model.config.num_hidden_layers = layers
    gc.collect()
    torch.cuda.empty_cache()
    log(f"llama_7b cut to {layers} of its {full} layers (full width) for "
        f"phases 9, 9b and 13: {model.num_params()} params")
    return model


def main():
    t0 = time.perf_counter()
    timed("1 (device)", phase_device)
    timed("2 (build)", phase_build)
    k1 = timed("3 (K1)", phase_k1)
    k2 = timed("4 (K2)", phase_k2)
    k34 = timed("5 (K3/K4)", phase_k34)
    decisions = timed("6 (router)", phase_router)
    timed("7 (tiny models, reference)", phase_tiny_reference)
    timed("7 (tiny models, training)", phase_tiny_train)
    model = timed("8 (llama_7b build)", build_llama_7b)
    serve = timed("8 (serving slice)", phase_slice, decisions["prefill"][0],
                  model)
    # the sweep's rates are set for the full depth's saturation
    timed("12 (loadgen)", phase_loadgen, model)
    model = cut_depth(model, SERVING_DEPTH)
    plain9, bf16_logits = timed("9 (engine)", phase_engine, model)
    timed("9b (engine knobs)", phase_knobs, model, plain9, bf16_logits)
    predictor = timed("13 (predictor)", phase_predictor, model,
                      decisions["prefill"][0])
    engine29 = timed("29 (d, e) (the engine through pir_jit, TP replicas)",
                     phase_engine_pir, model, plain9)
    del model
    epilogue = timed("10 (fused epilogue)", phase_epilogue, decisions)
    train = timed("11 (training)", phase_train, decisions["train"][0])
    bert, bert_ms = timed("14 (BERT)", phase_bert, decisions["bert"][0])
    gpt = timed("15 (GPT)", phase_gpt)
    resnet = timed("16 (ResNet-50)", phase_resnet)
    decode = timed("17 (decode legs)", phase_decode)
    zoo = timed("18 (vision zoo)", phase_zoo)
    hapi = timed("19 (high-level API)", phase_hapi, decisions["bert"][0],
                 bert_ms)
    mt = timed("20 (machine translation)", phase_mt)
    vision = timed("21 (ViT, DDPM, new ops)", phase_vision)
    hvp = timed("22 (second order, llama_1.3b)", phase_second_order)
    sparse = timed("23 (graphs, 2:4 sparsity, MoE, distribution)",
                   phase_graph_sparsity, decisions["bert"][0], bert_ms)
    plumbing = timed("24 (plumbing, distributed)", phase_plumbing)
    dist25 = timed("25 (DTensor, fleet, ZeRO, checkpoint)",
                   phase_distributed)
    pipe26, _ = timed("26 (pipeline, ring, EP-MoE, PS, guards)",
                      phase_pipeline_ring_moe_ps)
    timed("27 (serving mesh)", phase_mesh)
    ts28 = timed("28 (PIR, to_static)", phase_to_static)
    sh29 = timed("29 (a-c) (the sharding passes)", phase_sharding)
    log(f"phases 1-29: {time.perf_counter() - t0:.1f} s")
    src = "paddle_tpu_torch/csrc/flash_attention_"
    ref = "paddle_tpu/ops/pallas/flash_attention.py:"
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    # K1 runs on the serving (bf16 and int8), predictor, training, BERT,
    # GPT, decode, hapi BERT, Transformer-base, ViT, Hessian-vector,
    # 2:4-pruned BERT, reloaded llama_1.3b, distributed (to_static on
    # the 2x2 mesh, the fleet pipeline), phase 26 (the 1F1B, FThenB, ZB
    # and VPP runs over pp 4, the sep ring's calls) and phase 28 (the
    # to_static prefill and training step, the rewritten dense attention)
    # and phase 29 (the sharded and the searched llama_1.3b steps) paths; K2 on phase 10's fused epilogue and phase 28's rewritten one;
    # K3 and K4 on the training, BERT, hapi BERT, Transformer-base, ViT,
    # Hessian-vector (its ordinary backward), 2:4-pruned BERT, distributed,
    # phase 26's pipeline and phase 28's to_static training paths (the
    # graph, MoE, EP-MoE and PS paths, and phase 27's serving mesh, its
    # process workers, drill and loadgen, launch none; the ResNet,
    # vision-zoo, hapi ResNet and LeNet, LSTM seq2seq and DDPM paths add
    # none, counted all the same); their times are the Llama training
    # shape's (phases 3 and 5 print BERT's too). K2's are the serving
    # prefill shape's (no single library call computes it).
    # "ms" and "library_ms" are device times from back-to-back calls
    kernels = [dict(name="flash_fwd", route="cuda", source=src + "fwd.cu",
                    replaces=ref + "116",
                    launches=(serve + predictor + train["flash_fwd"]
                              + bert["flash_fwd"] + gpt
                              + resnet["flash_fwd"] + decode
                              + zoo["flash_fwd"] + hapi["flash_fwd"]
                              + mt["flash_fwd"] + vision["flash_fwd"]
                              + hvp["flash_fwd"] + sparse["flash_fwd"]
                              + plumbing + dist25["flash_fwd"]
                              + pipe26["flash_fwd"] + ts28["flash_fwd"]
                              + sh29["flash_fwd"] + engine29),
                    **{key: k1["train"][key] for key in keys}),
               dict(name="flash_fwd_rms_epilogue", route="cuda",
                    source=src + "fwd.cu", replaces=ref + "116",
                    launches=(epilogue + ts28["flash_fwd_rms_epilogue"]
                              + sh29["flash_fwd_rms_epilogue"]),
                    **{key: k2["prefill"][key] for key in keys}),
               dict(name="flash_bwd_dq", route="cuda", source=src + "bwd.cu",
                    replaces=ref + "198",
                    launches=(train["flash_bwd_dq"] + bert["flash_bwd_dq"]
                              + resnet["flash_bwd_dq"] + zoo["flash_bwd_dq"]
                              + hapi["flash_bwd_dq"] + mt["flash_bwd_dq"]
                              + vision["flash_bwd_dq"]
                              + hvp["flash_bwd_dq"]
                              + sparse["flash_bwd_dq"]
                              + dist25["flash_bwd_dq"]
                              + pipe26["flash_bwd_dq"]
                              + ts28["flash_bwd_dq"]
                              + sh29["flash_bwd_dq"]),
                    **k34["train"]["dq"]),
               dict(name="flash_bwd_dkv", route="cuda", source=src + "bwd.cu",
                    replaces=ref + "249",
                    launches=(train["flash_bwd_dkv"] + bert["flash_bwd_dkv"]
                              + resnet["flash_bwd_dkv"]
                              + zoo["flash_bwd_dkv"]
                              + hapi["flash_bwd_dkv"]
                              + mt["flash_bwd_dkv"]
                              + vision["flash_bwd_dkv"]
                              + hvp["flash_bwd_dkv"]
                              + sparse["flash_bwd_dkv"]
                              + dist25["flash_bwd_dkv"]
                              + pipe26["flash_bwd_dkv"]
                              + ts28["flash_bwd_dkv"]
                              + sh29["flash_bwd_dkv"]),
                    **k34["train"]["dkv"])]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
