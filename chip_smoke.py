#!/usr/bin/env python3
"""Smoke run of poulpy_tpu_torch on one CUDA card: each ported path, once.

    python3 chip_smoke.py

Twenty-four paths of the port run, each with the launch counters set to 0
just before it and read just after:

- the product path, the headline operation of bench.py: a batched GLWE ×
  GGSW external product at N = 2048, base2k = 17, ciphertext k = 51 (3
  limbs), GGSW k = 68 (dnum 3, rank 1, dsize 1), on get_module(2048, 2, 28);
- the gate path, bench_full.py's gate bootstrap: GateParams(n_lwe=568,
  block_size=8) (N 1024, base2k 17, k_ct 34, BRK k 68 dnum 4, KSK k 51
  dnum 2, get_module(1024, 2, 28)) at batch 1024: block-binary blind
  rotation (71 blocks: 35 chained launches of two block steps, then one
  single step), GLWE → LWE keyswitch, sample extraction;
- the keyswitch path, bench_full.py's keyswitch: N = 2048,
  get_module(2048, 2) (30-bit primes), ciphertext k 51, key k 68, dnum 3;
- the ckks_wide path, bench_full.py's bench_ckks_mul_wide (the reference's
  CKKS demo parameters): N 2048, base2k 52, ct k 95, tensor key k 156 dnum 2,
  ternary secret of Hamming weight 192, get_module(2048, 5, 28), batch 256:
  ct × ct multiply through the fused wide pair (tensor, relinearize);
- the ckks path, bench_full.py's bench_ckks_mul: base2k 17, ct k 95, key k 95
  dnum 6, get_module(2048, 2, 28), batch 256: multiply (NTT and VMP kernels)
  then rescale(5);
- the relinearize path, on the ckks path's keys and ciphertexts:
  glwe_tensor_relinearize of a ciphertext pair at batch 256 through the fused
  pair (the tensor kernel, then the product kernel with the small64 add);
- the ckks_rotate path, on the same keys and ciphertexts with the
  automorphism keys of galois_element(1) and −1 (base2k 17, k 95, dnum 6):
  CKKS rotate and conjugate at batch 256, each one keyswitch through the
  product kernel with the body add, its output columns split across blocks;
- product_mxu and product_fused_mxu, on the product path's keys and batch:
  the product through `route="mxu"` (four-step forward, VMP, four-step
  inverse, Garner exit: four launches) and `route="fused_mxu"` (one fused
  launch);
- keyswitch_mxu and keyswitch_fused_mxu, on the keyswitch path's keys: the
  keyswitch through the same two routes;
- gate_fused_mxu, on the gate path's keys and batch: the gate bootstrap
  through `route="fused_mxu"` (one fused MXU block step per block of the
  blind rotation, the keyswitch through the fused MXU product);
- cbt and cbt_block8, bench_schemes.py's circuit bootstrapping (LWE bit →
  GGSW): N 1024 on get_module(1024, 2, 28), base2k 13, blind-rotation,
  automorphism and tensor keys k 52 dnum 3, an output GGSW of k 26 dnum 2,
  log_domain 1, to-constant; cbt with a binary secret of n_lwe 574 (one
  folded step per coefficient: the fused product with the rotate-and-
  subtract in its exit), cbt_block8 with a block-binary one of 576
  in blocks of 8 (36 chained launches of two block steps); then the trace
  (one keyswitch per level and digit) and the GGSW expansion (NTT and VMP
  kernels);
- fheuint_add, bench_schemes.py's FheUint u32 add (after poulpy-bench
  bdd_arithmetic.rs): N 1024 on get_module(1024, 2, 28), a block-binary LWE
  secret of 679 in blocks of 7, base2k 15, ciphertexts k 30, CBT keys k 60
  dnum 4, the GLWE → LWE key k 30 dnum 2, selectors k 45 dnum 3: each
  operand's 32 bits circuit-bootstrapped in one batch (`fheuint_prepare`:
  the GLWE → LWE keyswitch, 97 block steps in 48 chained launches and a
  single one, the trace, the expansion),
  then the add's 1,584 BDD nodes, one CMux (one fused product) each;
- blind_retrieval, on fheuint_add's keys: 256 FheUint u32 GLWEs read at an
  encrypted 8-bit index through the streaming retriever, the CMux tree and
  the butterfly of conditional swaps;
- compressed_gate, the gate path's configuration with its keys shipped
  seed-compressed: the client draws gates.keygen's stream with the
  compressed BRK and GLWE → LWE key in place of the direct ones and
  serializes them in the JAX package's wire format; the server reads them
  onto the card, regenerates the masks (host ChaCha8 draws, one upload) and
  prepares the keys (NTT kernel), then one NAND at batch 1024 (block steps,
  the `small` keyswitch) and the noise of the decompressed GGSWs (the NTT
  kernels both ways);
- cbt_fused_mxu, cbt_block8_fused_mxu and cbt_mxu, on the two CBT paths'
  set-ups: the same CBTs through `route="fused_mxu"` (the blind rotation's
  fused MXU products or block steps, the trace's fused MXU keyswitches) and
  the standard one through `route="mxu"` (the blind rotation stays on the
  butterfly kernels, as in the JAX package; the trace's keyswitches take the
  four MXU launches);
- fheuint_add_fused_mxu, on fheuint_add's keys: the three operands prepared
  and the u32 add through `route="fused_mxu"` (one fused MXU product per
  CMux);
- routes, on fheuint_add's keys and the ckks path's set-up: blind retrieval
  of 256 entries and CKKS rotate / conjugate through the default route,
  then through "mxu" and "fused_mxu", each equal to the default's;
- examples: the ten modules of `poulpy_tpu_torch/examples/` on the card,
  through the default route and "fused_mxu", against their CPU runs;
- mesh, the multi-card layer (`poulpy_tpu_torch/parallel/`) at the rank
  count of one card: one NCCL process group of world 1 in this process, the
  (dp, tp) mesh over it, and on the set-ups of the product, gate, ckks and
  cbt paths (parked on the host after their last earlier use): the four dp
  entry points on `module_with_mesh`, the prime-, ring- and key-sharded
  builders at tp, sp and kp 1, and the rank-local steps of 2-way layouts.

The seven paths before the MXU paths run as they would without them: the
three set-ups the MXU paths reuse wait on the host meanwhile; the two CBT
paths follow the MXU paths, and the MXU kernels' checks (3′, with their
float64 plain versions and cuBLAS yardstick) and the large-N checks come
last; the route paths after compressed_gate, on the CBT, fheuint_add and
ckks set-ups (parked on the host in between); the mesh path runs after the
last of the others.  Each set-up is freed after its last use.

Phases, each printing JSON lines, in this order (3′, 3‴ and 3″ last):

  1. device      card name and power limit (nvidia-smi), torch and CUDA versions;
  2. build       nvcc build of the kernels of csrc/ (sm_90a), then what ptxas
                 reported for the Garner exit's instances, the MXU
                 transforms' wg designs, both tensor kernels' instances,
                 both wide product designs' instances, both NTT designs'
                 and fused_product_tile.cu's (registers, stack frame,
                 spills);
  2′. native     the g++ build of the native host tier
                 (poulpy_tpu_torch/native/kernels.cpp: g++'s version, the
                 build seconds, the host CPU), then each of its entry
                 points against its plain version on the same inputs,
                 tolerance 0, both timed on the host clock: the ChaCha8
                 keystream against hal/source.py's numpy blocks at block
                 counters 0, 12345 and 2^33 (and 2^20 blocks against
                 plain_keystream), znx rotate and automorphism,
                 normalization and the NTT both ways against the port's
                 torch functions at N 1024 and 2048 (the int64 extremes
                 among the inputs), the i128 convolution against a Python
                 big-int product; one line {"native": [...]};
  3. kernels     each CUDA kernel against its plain PyTorch version on the same
                 CUDA inputs at its path's shapes, tolerance 0, with its time,
                 the plain version's time and the bound (the least time the
                 card could take: bytes over 3.35 TB/s or modular products
                 over the int32 rate or int8 multiply-adds over the tensor
                 cores' int8 rate, the largest; the wide kernels at the
                 wide CKKS mul's shapes, the tensor kernel and the small64
                 and small products at the relinearize and ckks_rotate
                 paths' shapes, batch 256; the VMP also at the non-wide
                 CKKS mul's shape and on the 30-bit basis of the "mxu"
                 keyswitch, batch 256; the NTT also at the non-wide CKKS
                 mul's four transform shapes, batch 256; the wide product
                 also at a 30-bit wide keyswitch's shape, P 4, batch 256,
                 its runtime-shaped instance; the fused product, the
                 folded blind-rotation step (against the unfolded loop
                 body too, amounts 0, N − 1, N, 2N − 1 and negative), the
                 `small` form and the block step at the CBT paths' shapes,
                 batch 1024, after a line naming the instance each takes,
                 specialised or runtime-shaped, the `small` form's against
                 the runtime-shaped instance it replaces); the chain of two
                 block steps in one launch (br_block_chain) at the gate's,
                 the CBT's and fheuint_prepare's shapes, then at the gate's
                 timed in turns beside two single launches of the same key
                 elements (br_block_chain_ab); the NTT, the butterfly
                 product and block step, both tensor kernels and the wide
                 product (the lazy design, which the paths run) and the
                 VMP (the tile design) also against their parent design,
                 equal and timed in the same way;
  3′. kernels    the same for the MXU route's kernels, after the last path: at
                 the product path's shapes, the fused MXU product with the
                 body at the keyswitch path's, batch 256, and the block step
                 at the gate path's, batch 1024; at the route paths' first
                 shapes (runtime-shaped instances): the fused MXU product at
                 the CBT's blind rotation and its `small` form at the
                 trace's keyswitch (batch 1024), the "mxu" route's forward,
                 VMP, inverse and Garner exit at that keyswitch, the block
                 step at fheuint_prepare's block 7 (batch 32); each with the time of
                 torch._int_mm on its step-B-shaped digit product as a
                 library yardstick of the product part alone; the forward,
                 the inverse (their wg designs) and the Garner exit (its tile
                 design) also at the keyswitch path's 30-bit shapes (batch
                 256, the exit with its 3-limb body), and each against its
                 parent design, equal and timed;
  3‴. stages     the fused kernels' stage clocks, after 3′: the fused MXU
                 kernel's at the product, keyswitch (`small`) and gate (block
                 step) paths' shapes (the stage clock's TIMED instances
                 exist for the shapes of `TILE_SHAPES` only, so not at 3′'s
                 runtime-shaped route-path shapes), for the parent design
                 (one ciphertext
                 per block) and the tile design that the paths run; then the
                 butterfly kernels' (fused_product.cu, br_block_step.cu) at
                 the product, keyswitch `small`, rotation `small`, small64
                 and gate block-step shapes, for the parent and the lazy
                 design, and at the CBT's product, step and trace keyswitch
                 (fused_product_tile.cu) beside the gate's keyswitch, also
                 for the runtime-shaped instance (which the CBT's instances
                 replace there); each with the kernel's
                 time and, from one launch of
                 its TIMED instance (whose output must equal the untimed
                 one's), the SM cycles per block of each stage (MXU: input
                 planes, forward steps A and B, VMP, inverse steps A and B,
                 exit; butterfly: entry, forward NTT, VMP, inverse NTT,
                 exit), their shares and those shares of the time; then the
                 MXU forward's and inverse's (mxu_ntt.cu) at the product and
                 keyswitch paths' shapes, for the parent and the wg design
                 (parent: planes, step A, step B; the forward's wg design:
                 the wait for its input, step A, step B's products and
                 epilogues; the inverse's: planes, step A's products and
                 epilogues, step B); then the tensor kernels'
                 (tensor_product.cu, wide_tensor.cu) at the relinearize and
                 the CKKS-wide mul's shapes, for the parent and the lazy
                 design (and the wide kernel's lazy design with a pair per
                 task): entry and forward NTT, convolution, inverse NTT,
                 lift; then the wide product's (wide_product.cu) at the
                 CKKS-wide mul's relinearization, for the parent and the
                 lazy design: entry and forward NTT, VMP, inverse NTT,
                 lift;
  3″. kernels_large_n  each product kernel at a shape whose rows do not fit
                 in shared memory (N 8192 for bench.py's product, N 4096
                 for the CKKS key's keyswitch and relinearization exits,
                 the gate's block steps, the relinearize path's tensor
                 product and the CKKS-wide pair), batch 2–4,
                 against its plain version, tolerance 0, with the layout it
                 takes (it must be the global one) and its time;
  4. verify      product path: stage by stage (NTT → VMP → inverse NTT
                 kernels, plain Garner and normalize) equals the fused kernel
                 at batch 64, and the fused result decrypts to X·m exactly;
  5. bench       product path: bench.py's workload at B = 16384: keygen,
                 encryption, key preparation, 1 + 30 chained products; the
                 checksum sum(|out| mod 65536) must equal 6596757198292, the
                 value the JAX package's runs record (BENCH_r04/r05.json);
  6. gate_verify gate path at batch 64: the block-step kernel's blind
                 rotation equals the plain block path, NAND decrypts to
                 1 − (b1 & b2); the standard path (one folded step per
                 coefficient) at n_lwe 64, batch 64, passes the same check;
  7. gate_bench  gate path at batch 1024: keygen and encryption from
                 bench_full.py's seeds, 1 warm-up NAND whose fingerprint
                 sum(|data| mod 65536) must equal GATE_FINGERPRINT (the JAX
                 package's value on the CPU) and whose bits must be right,
                 then 5 timed chained NANDs out ← NAND(out, c2), ending in a
                 host checksum, decrypted against host-tracked bits; the
                 block-step launches per NAND (35 chained, 1 single);
  8. keyswitch   keyswitch path: the keyswitch kernel equals the plain
                 keyswitch at batch 8 and decrypts exactly; 16 chained
                 single-ciphertext keyswitches; 1 + 10 chained keyswitches at
                 batch 256;
  9. ckks_wide   set-up from bench_full.py's seeds; 1 warm-up mul of its pair
                 (c1, c2) broadcast to batch 256, whose row-0 fingerprint
                 sum(|data| mod 65536) must equal CKKS_WIDE_FINGERPRINT (the
                 JAX package's value on the CPU), every row equal, its decode
                 error against z·z printed; then 5 timed muls, each on a
                 distinct batch of 256 encrypted in set-up, ending in a host
                 checksum; then a profiled mul (torch.profiler, after a
                 warm-up step);
 10. ckks        the same for the non-wide mul + rescale(5) (CKKS_FINGERPRINT);
 11. relinearize 1 warm-up relinearization of the ckks path's pair (c1, c2)
                 broadcast to batch 256: RELIN_FINGERPRINT of row 0, every row
                 equal, the decryption against d0 + d1·s + d2·s² (log2 of the
                 torus error under RELIN_LOG2_ERR_MAX), the kernel route equal
                 to the unfused route at batch 8; then 5 timed
                 relinearizations on the ckks path's distinct batches, ending
                 in a host checksum; then a profiled one;
 12. ckks_rotate automorphism keys from Source 0x05 / 0x06; rotate and
                 conjugate of c1 broadcast to batch 256: ROTATE_FINGERPRINT
                 and CONJUGATE_FINGERPRINT of row 0, every row equal, the
                 decode error against np.roll(z, −1) and conj(z); then 5 timed
                 rotations on distinct batches, ending in a host checksum; then
                 a profiled one;
 13. verify_<route>, bench_<route> (product_mxu, product_fused_mxu): bench.py's
                 MXU A/B gate on phase 4's batch of 64 (the route equals the
                 butterfly fused kernel bit for bit and decrypts to X·m), then
                 phase 5's 1 + 30 chained products at B = 16384 on its keys
                 and batch through the route (checksum 6596757198292), then a
                 profiled product;
 14. keyswitch_<route> (keyswitch_mxu, keyswitch_fused_mxu): on phase 8's
                 keys, the route equals the butterfly route at batch 8 and
                 decrypts exactly; 1 + 10 chained keyswitches at batch 256,
                 whose checksum equals the butterfly route's;
 15. gate_fused_mxu  on phase 6–7's keys: at batch 64 the block path through
                 the route equals its plain MXU block path and the butterfly
                 block path, the standard path (n_lwe 64) through the route
                 equals the butterfly's, NAND truth on both; at batch 1024
                 the warm-up NAND's fingerprint equals GATE_FINGERPRINT, 5
                 timed chained NANDs decrypt to the tracked bits (gates/s
                 beside phase 7's), then a profiled NAND;
 16. cbt, cbt_block8  set-up from bench_schemes.py's seeds (set-up seconds);
                 at batch 4 the card's CBT equals the port's CPU run on the
                 same keys (cbt_block8: also through the extended path,
                 extension_factor 2), and three of its GGSWs, prepared,
                 take a noiseless GLWE of m to bit·m within
                 CBT_DECRYPT_BOUND (the JAX package's reading, see there);
                 at batch 32 the warm-up's fingerprint equals the JAX
                 package's (CBT_FINGERPRINT, CBT_BLOCK8_FINGERPRINT), 3
                 timed CBTs on distinct batches end in a host checksum
                 (cbt/s, launches, peak memory), a profiled CBT; at batch
                 1024, 3 timed CBTs on distinct batches, four sampled rows
                 decrypt-checked; at each batch the split: the blind
                 rotation, the trace and the expansion run apart, the
                 device synchronised between them, each with its
                 launches and a profile (device busy), their result equal
                 to the CBT's; the standard path's blind rotation (also on
                 the "mxu" route) launches one fused_br_step per LWE
                 coefficient and nothing else of csrc/, block 8's 36
                 br_block_chain launches and nothing else, and the former's profile
                 holds no per-step glue (at most CBT_BR_GLUE_EVENTS device
                 events besides the steps);
 17. fheuint_add set-up from bench_schemes.py's seeds (set-up seconds; a
                 public key, whose encryption of 0xDEADBEEF's bits on the
                 card equals the port's CPU run and decrypts exactly); the
                 three operands prepared (seconds per operand); the prepare
                 of a 4-bit FheUint and the add of the 32-bit pair on the
                 card equal the port's CPU runs; the warm-up add 255 + 30,
                 whose fingerprint equals the JAX package's
                 (FHEUINT_ADD_FINGERPRINT) and which decrypts to 285; 3 timed
                 adds on bench_schemes.py's pairs, ending in a host
                 checksum, each decrypted (adds/s, launches per add:
                 fused_product must equal the 1,584 CMuxes, peak memory); a
                 profiled add (device busy); each of the ten other ops on
                 (255, 30), decrypting to Python's int semantics, one
                 fused_product per CMux; phase 3 holds the CMux product
                 (batch 1 and 64), the prepare's two keyswitch shapes and
                 the block step at block 7, after a line naming the
                 instance each takes;
 18. blind_retrieval  the index prepared (`fheuint_prepare`, width 8); the
                 streaming retriever equals `blind_select` bit for bit and
                 decrypts to the entry, the butterfly puts it at position 0
                 and its reverse restores all 256; each timed with its
                 launches;
 19. compressed_gate  the client's compressed keygen (seconds, beside the
                 secrets'), serialize (seconds; the BRK blob, the switching
                 key's and the full GGSW stack's bytes), the BRK blob's
                 blake2b-8 equal to the JAX package's
                 (COMPRESSED_BRK_BLOB_DIGEST); the server's deserialize onto
                 the card and decompress + prepare (seconds), the BRK's
                 decompress again step by step (host draws through the
                 native keystream, upload, assembly, `vmp_prepare` with its
                 ntt_forward launches and shapes), equal to the whole call,
                 then the same draw once through the plain keystream (its
                 seconds; the same digits); the decompressed keys equal to the
                 direct keygen with each branched child (its seconds); one
                 NAND at batch 1024 on the gate path's bits: truth, the JAX
                 package's fingerprint (COMPRESSED_GATE_FINGERPRINT), its
                 block-step launches equal to phase 7's per NAND, then 3
                 timed NANDs; `ggsw_noise` of the decompressed GGSWs of LWE
                 coefficients 0 and 567 (every row, columns 0 and 1) on the
                 card equal to the port's CPU run, their log2 std beside the
                 fresh-encryption level; peak device memory.
 20. cbt_fused_mxu, cbt_block8_fused_mxu, cbt_mxu  on the CBT paths' set-ups:
                 at batch 4 the CBT through the route equals the default
                 route's on the card, three of its GGSWs decrypt within
                 CBT_DECRYPT_BOUND; then phase 16's bench through the route
                 (the fingerprints CBT_FINGERPRINT / CBT_BLOCK8_FINGERPRINT,
                 batch 32 and 1024, the split and the profiles);
 21. fheuint_add_fused_mxu  the three operands prepared through the route
                 (equal to phase 17's selectors), then phase 17's bench
                 through it (FHEUINT_ADD_FINGERPRINT, 285, one
                 fused_mxu_product per CMux, the ten other ops); the σ
                 kernel layout of a selector, which the fused MXU product
                 rebuilds on every CMux, timed alone and as a share of an add;
 22. routes      phase 18 and phase 12 again through the default route, then
                 through "mxu" and "fused_mxu": every output equal to the
                 default route's (the index's selectors, the retriever,
                 blind_select, the butterfly and its reverse; rotate and
                 conjugate at batch 256 with their fingerprints), each timed;
 23. examples    each of the ten examples on the CPU, then on the card
                 through the default route and "fused_mxu": the numbers of
                 the card's result lines equal the CPU's (seconds per run);
 24. mesh        an NCCL group of world 1 (FileStore in a temporary
                 directory; every mesh axis's group on NCCL) and make_mesh()
                 on it; through module_with_mesh: the product's 1 + 30
                 chained products at B = 16384 (checksum 6596757198292), the
                 NAND of sharded_gate_bootstrap_fn at batch 1024
                 (GATE_FINGERPRINT), the ckks pair's mul + rescale(5) at batch
                 256 (CKKS_FINGERPRINT) and the cbt path's warm-up batch of
                 32 (CBT_FINGERPRINT), each output a DTensor placed Shard(0)
                 on dp, each timed against the mesh-less call in turns; the
                 prime-sharded product (tp 1) and the ring-sharded one (sp 1)
                 at batch 1024 and the key-sharded block blind rotation (kp 1)
                 on the gate's keys at batch 1024, each equal to its mesh-less
                 path and issuing, per op, the JAX package's collectives (one
                 all_gather; four all_to_alls; one all_reduce per block step),
                 counted in parallel/collectives.py; then, for tp 2 and kp 2,
                 ranks 0 and 1's local steps on the card at full width (the
                 residues of one prime before the all_gather through the NTT
                 and VMP kernels at P 1; the first block step's NTT-domain
                 update of four members before the all_reduce) equal to the
                 same steps on the CPU, batch 64; peak device memory.

Only the *_mxu paths, routes and examples may launch an MXU kernel.  After each path the
NTT kernel's launches per (direction, primes, N, rows per prime, prime
bits) of that path (ntt_shapes); after 3″ the NTT at each of those shapes
on that basis, both designs equal to the plain version and timed through
the wrapper and, in a CUDA graph, on the device alone, each with its
launches × (ms − bound) over all the paths (ntt_shape, and their sums per
direction and design).  Then one line
{"kernels": [...]} (launches summed over the paths' runs)
and, last, {"ok": true, "device": {...}}.  Any failure exits non-zero
before that line.  Without a CUDA device, or without the poulpy_tpu_torch
package beside this file, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from collections import Counter
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent

N, BASE2K, K_CT, K_PT, K_KEY, DNUM = 2048, 17, 51, 34, 68, 3
NPRIMES, PRIME_BITS = 2, 28
BATCH, ITERS, VERIFY_BATCH = 16384, 30, 64
CHECKSUM = 6596757198292
PLAIN_CHUNK = 2048          # batch chunk of the plain versions of the VMP and the fused product

# gate path: bench_full.py bench_gate_bootstrap
GATE_N_LWE, GATE_BLOCK, GATE_BATCH, GATE_ITERS = 568, 8, 1024, 5
GATE_VERIFY_BATCH, STD_N_LWE = 64, 64
# sum(|data| mod 65536) of gate_nand(keys, c1, c2) at bench_full.py's gate
# configuration and seeds, batch 1024, computed by the JAX package on the CPU
# (tests/test_torch_binfhe.py::test_gate_fingerprint_full_config recomputes it)
GATE_FINGERPRINT = 38199110968
# keyswitch path: bench_full.py _keyswitch_setup / bench_keyswitch_*
KS_N, KS_K_KEY, KS_DNUM = 2048, 68, 3
KS_VERIFY_BATCH, KS_CHAIN, KS_REPS, KS_BATCH, KS_ITERS = 8, 16, 5, 256, 10
# the circuit-bootstrapping paths: bench_schemes.py bench_circuit_bootstrap
# (after poulpy-bench circuit_bootstrapping.rs): N 1024 on get_module(1024, 2,
# 28), base2k 13, rank 1, blind-rotation / automorphism / tensor keys k 52
# dnum 3, an output GGSW of k 26 dnum 2, LWE k 13, log_domain 1, to-constant;
# cbt: a binary_prob secret of 574 coefficients; cbt_block8: binary_block of
# 576 in blocks of 8 (bench_schemes.py:201-203)
CBT_N, CBT_BASE2K, CBT_K_KEY, CBT_DNUM_KEY, CBT_K_RES, CBT_DNUM_RES = 1024, 13, 52, 3, 26, 2
CBT_K_LWE, CBT_LOG_DOMAIN = 13, 1
CBT_N_LWE, CBT_BLOCK8_N_LWE, CBT_BLOCK = 574, 576, 8
CBT_BATCH, CBT_ITERS, CBT_VERIFY_BATCH, CBT_WIDE_BATCH, CBT_WIDE_ITERS = 32, 3, 4, 1024, 3
# sum(|ggsw.data| mod 65536) of the warm-up batch (the last of CBT_ITERS + 1
# encrypted batches of arange(32) % 2) on each path, computed by the JAX
# package on the CPU (tests/test_torch_cbt.py::test_cbt_fingerprints_full_config
# recomputes them)
CBT_FINGERPRINT = 1194772570
CBT_BLOCK8_FINGERPRINT = 1190505081
# The external-product check: a noiseless GLWE whose body and mask limb 0 are
# ternary (default_rng(11)), so that it encrypts m = body + mask·s at the
# 2^-13 scale with digits of 1, times a prepared CBT output; |decrypt −
# bit·m| at the 2^-26 scale (centred mod 2^26) must stay within
# CBT_DECRYPT_BOUND: twice the largest error the JAX package reads over the
# 32 GGSWs of the warm-up batch on the CPU on either path (293,679 on the
# standard path, 112,428 on the block path; tests/test_torch_cbt.py::
# test_cbt_fingerprints_full_config recomputes them).  The output GGSW of k
# 26 keeps no noise margin: its expanded column carries noise near 2^-14, so a
# fresh GLWE, whose 13-bit digits fill every coefficient, decrypts to noise
# over the whole torus (the JAX package reads errors of 2^25 at this scale).
CBT_MSG_SEED, CBT_DECRYPT_BOUND = 11, 2 * 293679
# device events the standard blind rotation may run besides its n_lwe folded
# steps (mod_switch_2n, the accumulator's set-up, the final normalization);
# the unfolded loop ran five or more per coefficient
CBT_BR_GLUE_EVENTS = 64
# the fheuint_add and blind_retrieval paths: bench_schemes.py bench_u32_add (after
# poulpy-bench bdd_arithmetic.rs's Add): N 1024 on get_module(1024, 2, 28), a
# binary_block LWE secret of 679 in blocks of 7, base2k 15, rank 1, FheUint
# ciphertexts k 30, selectors (the CBT's GGSWs) k 45 dnum 3, CBT keys k 60 dnum 4,
# the GLWE → LWE key k 30 dnum 2; operands 255, 30 (the reference bench's) and 77
# at width 32, the warm-up add (255, 30), the timed pairs (30, 77), (77, 255),
# (30, 255)
BDD_N, BDD_N_LWE, BDD_BLOCK, BDD_BASE2K = 1024, 679, 7, 15
BDD_K_CT, BDD_K_GGSW, BDD_DNUM_GGSW, BDD_K_CBT, BDD_DNUM_CBT, BDD_DNUM_KS = 30, 45, 3, 60, 4, 2
BDD_WIDTH, BDD_VALUES, BDD_PAIRS, BDD_VERIFY_WIDTH = 32, (255, 30, 77), ((1, 2), (2, 0), (1, 0)), 4
# sum(|data| mod 65536) of the warm-up add at that configuration and those
# seeds, computed by the JAX package on the CPU (tests/test_torch_bdd.py::
# test_fheuint_add_fingerprint_full_config recomputes it); the u32 add's BDDs
# have 1,584 nodes, one CMux (one fused_product launch) each
FHEUINT_ADD_FINGERPRINT = 33915379
FHEUINT_ADD_CMUXES = 1584
# the kernel each route launches once per CMux of the BDD paths
CMUX_KERNEL = {"fused": "fused_product", "fused_mxu": "fused_mxu_product", "mxu": "garner_exit"}
# blind_retrieval: BR_ENTRIES FheUint u32 GLWEs read at an encrypted
# BR_INDEX_WIDTH-bit index
BR_ENTRIES, BR_INDEX_WIDTH, BR_INDEX, BR_SEED = 256, 8, 173, 21
# compressed_gate: the gate path's configuration and gates.keygen's stream of
# draws, with seed-compressed keys in place of the direct ones, shipped in the
# JAX package's wire format.  blake2b-8 of the BRK blob, and sum(|data| mod
# 65536) of one NAND at batch 1024 on the decompressed keys (the gate path's
# bits and encryptions), computed by the JAX package on the CPU
# (tests/test_torch_compressed.py::test_compressed_gate_constants_full_config
# recomputes them)
COMPRESSED_BRK_BLOB_DIGEST = 12522800189733129592
COMPRESSED_GATE_FINGERPRINT = 38185105306
# the noise read: the decompressed GGSWs of these LWE coefficients, every row,
# columns 0 and 1
NOISE_COEFFS, NOISE_SIGMA = (0, 567), 3.2


@dataclass(frozen=True)
class CkksConfig:
    """A CKKS multiply benchmark of bench_full.py: its parameters and seeds."""

    n: int
    nprimes: int
    base2k: int
    k_ct: int
    k_key: int
    log_delta: int
    log_budget: int
    dnum: int
    hw: int | None          # Hamming weight of a ternary_hw secret; None: ternary_prob
    seed: int               # np.random.default_rng seed of the slots
    rescale: int | None     # rescale(k) after the multiply


# bench_full.py bench_ckks_mul_wide and bench_ckks_mul (prime_bits 28 for both)
CKKS_WIDE = CkksConfig(2048, 5, 52, 95, 156, 30, 35, 2, 192, 5, None)
CKKS = CkksConfig(2048, 2, 17, 95, 95, 22, 30, 6, None, 3, 5)
CKKS_BATCH, CKKS_ITERS = 256, 5
# sum(|data| mod 65536) of one multiply (+ rescale) of bench_full.py's pair at
# each configuration, computed by the JAX package on the CPU
# (tests/test_torch_ckks.py::test_ckks_fingerprint_full_config recomputes them)
CKKS_WIDE_FINGERPRINT = 270715177
CKKS_FINGERPRINT = 808555351
# sum(|data| mod 65536) of glwe_tensor_relinearize(c1.glwe, c2.glwe) and of
# rotate(c1) / conjugate(c1) at the ckks configuration, computed by the JAX
# package on the CPU (tests/test_torch_relin.py::
# test_relinearize_and_rotation_fingerprints_full_config recomputes them)
RELIN_FINGERPRINT = 1476054215
ROTATE_FINGERPRINT = 797964655
CONJUGATE_FINGERPRINT = 802332334
# log2 of the torus error of the relinearization against d0 + d1·s + d2·s²:
# the JAX package reads −64.0 on the CPU at this configuration (float64
# rounding of the decode; the keyswitch noise of the k 95 key lies below it)
RELIN_LOG2_ERR_MAX = -50
# the wide mul's landing offset off_bits − base2k = (65 + 65) − 30 − 35 − 52
WIDE_OFFSET = 13

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
# int32 multiply rate of an H100 SXM: 132 SMs × 64 int32 lanes × 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# int8 multiply-adds of the H100 SXM's tensor cores: 1,979 T dense int8 ops/s
INT8_MACS_PER_S = 1979e12 / 2
# the MXU routes of the product and keyswitch paths (core route keyword)
ROUTES = ("mxu", "fused_mxu")
# the fused MXU kernel's designs in the stage-clock phase (backends/fused_mxu.py)
DESIGNS = ("parent", "tile")
# the butterfly kernels' designs there (backends/fused.py)
BUTTERFLY_DESIGNS = ("parent", "lazy")
# at the CBT's shapes also the runtime-shaped instance, which
# fused_product_tile.cu's replace there
CBT_DESIGNS = ("parent", "runtime", "lazy")
# the MXU transforms' designs (csrc/mxu_ntt.cu), timed by their stage clocks in 3‴
TRANSFORM_DESIGNS = ("parent", "wg")

_FUSED = "poulpy_tpu/backends/pallas_fused.py:951"
_WIDE = "poulpy_tpu/backends/pallas_wide.py"
_FUSED_MXU = "poulpy_tpu/backends/pallas_fused_mxu.py:271"
KERNELS = {
    "ntt_forward": ("poulpy_tpu_torch/csrc/ntt.cu", "poulpy_tpu/backends/pallas_ntt.py:407"),
    "ntt_inverse": ("poulpy_tpu_torch/csrc/ntt.cu", "poulpy_tpu/backends/pallas_ntt.py:407"),
    "vmp": ("poulpy_tpu_torch/csrc/vmp.cu", "poulpy_tpu/backends/pallas_vmp.py:67"),
    "fused_product": ("poulpy_tpu_torch/csrc/fused_product.cu", _FUSED),
    "fused_product_small": ("poulpy_tpu_torch/csrc/fused_product.cu", _FUSED),
    "fused_product_small64": ("poulpy_tpu_torch/csrc/fused_product.cu", _FUSED),
    "fused_br_step": ("poulpy_tpu_torch/csrc/fused_product_tile.cu", _FUSED),
    "br_block_step": ("poulpy_tpu_torch/csrc/br_block_step.cu", _FUSED),
    "br_block_chain": ("poulpy_tpu_torch/csrc/br_block_step.cu", _FUSED),
    "tensor_product": ("poulpy_tpu_torch/csrc/tensor_product.cu",
                       "poulpy_tpu/backends/pallas_fused.py:1403"),
    "wide_product": ("poulpy_tpu_torch/csrc/wide_product.cu", f"{_WIDE}:496"),
    "wide_tensor": ("poulpy_tpu_torch/csrc/wide_tensor.cu", f"{_WIDE}:718"),
    "mxu_forward": ("poulpy_tpu_torch/csrc/mxu_ntt.cu", "poulpy_tpu/backends/pallas_mxu.py:268"),
    "mxu_inverse": ("poulpy_tpu_torch/csrc/mxu_ntt.cu", "poulpy_tpu/backends/pallas_mxu.py:311"),
    "garner_exit": ("poulpy_tpu_torch/csrc/garner_exit.cu", "poulpy_tpu/backends/pallas_fused.py:1030"),
    "fused_mxu_product": ("poulpy_tpu_torch/csrc/fused_mxu.cu", _FUSED_MXU),
    "fused_mxu_product_small": ("poulpy_tpu_torch/csrc/fused_mxu.cu", _FUSED_MXU),
    "fused_mxu_br_block_step": ("poulpy_tpu_torch/csrc/fused_mxu.cu", _FUSED_MXU),
}
# the kernels of the block blind rotation's steps (block_launches)
BLOCK_STEP_KERNELS = ("br_block_step", "br_block_chain", "fused_mxu_br_block_step")
MXU_KERNELS = ("mxu_forward", "mxu_inverse", "garner_exit", "fused_mxu_product",
               "fused_mxu_product_small", "fused_mxu_br_block_step")
# the kernels each path must launch
PATHS = {
    "product": ("ntt_forward", "ntt_inverse", "vmp", "fused_product"),
    "gate": ("ntt_forward", "fused_br_step", "fused_product_small", "br_block_step",
             "br_block_chain"),
    "keyswitch": ("ntt_forward", "fused_product_small"),
    "ckks_wide": ("wide_tensor", "wide_product"),
    "ckks": ("ntt_forward", "ntt_inverse", "vmp"),
    "relinearize": ("tensor_product", "fused_product_small64"),
    "ckks_rotate": ("ntt_forward", "fused_product_small"),
    "product_mxu": ("fused_product", "mxu_forward", "vmp", "mxu_inverse", "garner_exit"),
    "product_fused_mxu": ("fused_product", "fused_mxu_product"),
    "keyswitch_mxu": ("fused_product_small", "mxu_forward", "vmp", "mxu_inverse",
                      "garner_exit"),
    "keyswitch_fused_mxu": ("fused_product_small", "fused_mxu_product_small"),
    "gate_fused_mxu": ("br_block_step", "br_block_chain", "fused_br_step",
                       "fused_mxu_br_block_step",
                       "fused_mxu_product", "fused_mxu_product_small"),
    "cbt": ("fused_br_step", "fused_product_small", "ntt_forward", "ntt_inverse", "vmp"),
    "cbt_block8": ("br_block_chain", "fused_product_small", "ntt_forward", "ntt_inverse",
                   "vmp"),
    "fheuint_add": ("fused_product", "fused_product_small", "br_block_step", "br_block_chain",
                    "ntt_forward", "ntt_inverse", "vmp"),
    "blind_retrieval": ("fused_product", "fused_product_small", "br_block_step",
                        "br_block_chain", "ntt_forward", "ntt_inverse", "vmp"),
    "compressed_gate": ("ntt_forward", "ntt_inverse", "br_block_step", "br_block_chain",
                        "fused_product_small"),
    "cbt_fused_mxu": ("fused_mxu_product", "fused_mxu_product_small", "ntt_forward",
                      "ntt_inverse", "vmp"),
    "cbt_block8_fused_mxu": ("fused_mxu_br_block_step", "fused_mxu_product_small", "ntt_forward",
                             "ntt_inverse", "vmp"),
    "cbt_mxu": ("fused_br_step", "mxu_forward", "vmp", "mxu_inverse", "garner_exit"),
    "fheuint_add_fused_mxu": ("fused_mxu_product", "fused_mxu_product_small",
                              "fused_mxu_br_block_step"),
    "routes": ("fused_mxu_product", "fused_mxu_product_small", "fused_mxu_br_block_step",
               "mxu_forward", "vmp", "mxu_inverse", "garner_exit"),
    "examples": (),
    "mesh": ("ntt_forward", "ntt_inverse", "vmp", "fused_product", "fused_product_small",
             "fused_br_step", "br_block_step", "br_block_chain"),
}
# the paths that may launch an MXU kernel: the *_mxu paths, and two that run
# every route in turn
MXU_PATHS = ("routes", "examples")


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    query = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    return subprocess.run(query, capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def emit(**row):
    print(json.dumps(row), flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` over `reps` runs after one warm-up, by CUDA events."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Mean device milliseconds of `fn()` over `reps` calls captured in one
    CUDA graph and replayed between two CUDA events: the launches back to
    back, without the host's time between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def moved(obj, device):
    """`obj` with every tensor in it (through tuples, lists, dicts and the
    port's frozen dataclasses) on `device`; anything else as it is."""
    import dataclasses

    import torch

    if isinstance(obj, torch.Tensor):
        return obj.to(device)
    if isinstance(obj, (tuple, list)):
        return type(obj)(moved(o, device) for o in obj)
    if isinstance(obj, dict):
        return {k: moved(v, device) for k, v in obj.items()}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{f.name: moved(getattr(obj, f.name), device)
                                           for f in dataclasses.fields(obj)})
    return obj


def bound(nbytes: float, ops: float, macs: float = 0) -> dict:
    """The least time the card could take: bytes read once and written once
    over the memory rate, modular products over the int32 multiply rate
    (each needs at least one 32-bit multiply), or int8 multiply-adds over the
    tensor cores' int8 rate, whichever is largest."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(ops / INT32_OPS_PER_S, macs / INT8_MACS_PER_S) * 1e3
    return dict(bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
                bytes=nbytes, ops=ops, int8_macs=macs)


def split(n: int) -> tuple[int, int]:
    """The four-step split (n1, n2) of the MXU transforms."""
    n1 = min(128, max(2, n // 8))
    return n1, n // n1


def mxu_macs(rows: int, P: int, n: int, nd: int = 4) -> int:
    """int8 multiply-adds of the four-step transform of `rows` rows over P
    primes: step A [n1, nd·n2] × [nd·n2, 4·n2] and step B [n2, 4·n1] ×
    [4·n1, 4·n1] (the inverse: the same two shapes with nd 4)."""
    n1, n2 = split(n)
    return rows * P * (n1 * nd * n2 * 4 * n2 + n2 * 16 * n1 * n1)


def int_mm_ms(rows: int, n: int, device) -> float:
    """The library yardstick of the MXU kernels: one torch._int_mm of a
    [rows, 4·n1] int8 operand by a [4·n1, 4·n1] int8 matrix (the step-B digit
    product alone, without the digit planes, the epilogues or the VMP)."""
    import torch

    k = 4 * split(n)[0]
    a = torch.randint(-128, 128, (rows, k), dtype=torch.int8, device=device)
    w = torch.randint(-128, 128, (k, k), dtype=torch.int8, device=device)
    ms = cuda_ms(lambda: torch._int_mm(a, w), 5)
    del a, w
    torch.cuda.empty_cache()
    return ms


def ntt_ops(rows: int, n: int, inverse: bool = False) -> int:
    """Modular products of `rows` NTTs of n points (+ the N^{-1} scale)."""
    return rows * ((n // 2) * (n.bit_length() - 1) + (n if inverse else 0))


def fused_ops(B: int, kk: int, mdim: int, P: int, n: int, block: int = 1) -> int:
    """Modular products of the fused kernels: forward NTT of kk rows, the
    block·kk·mdim VMP, the x-power factor (block steps), inverse NTT of mdim
    rows, per prime and ciphertext (Garner and the exit not counted)."""
    rot = block * mdim * n if block > 1 else 0
    return B * P * (ntt_ops(kk, n) + block * kk * mdim * n + rot + ntt_ops(mdim, n, True))


def chunked(fn, a, *args):
    """fn over batch chunks of `a` (every plain version here is batch-wise)."""
    import torch

    return torch.cat([fn(a[i : i + PLAIN_CHUNK], *args) for i in range(0, a.shape[0], PLAIN_CHUNK)])


def keys_and_ciphertexts(m, batch: int, seed: int):
    """bench.py's set-up: secret, `batch` encryptions of random 16-bit data,
    and the prepared GGSW of X^1, from the same seeds."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.layouts import GLWEPlaintext
    from poulpy_tpu_torch.core.prepared import ggsw_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal import vec_znx
    from poulpy_tpu_torch.hal.source import Source

    src = Source(bytes(32))
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    skp = glwe_secret_prepare(m, enc.secret_new(m, 1, src))
    data = torch.from_numpy(
        np.random.default_rng(seed).integers(-(2**15), 2**15, size=(batch, N), dtype=np.int64)
    ).to(m.device)
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, data), base2k=BASE2K, k=K_PT)
    ct = enc.glwe_encrypt_sk(m, pt, skp, BASE2K, K_CT, xe, xa, batch_shape=(batch,))
    ptg = np.zeros(N, dtype=np.int64)
    ptg[1] = 1
    ggswp = ggsw_prepare(m, enc.ggsw_encrypt_sk(m, ptg, skp, BASE2K, K_KEY, dnum=DNUM,
                                                source_xe=xe, source_xa=xa))
    return skp, data, ct, ggswp


def tensor_ops(B: int, P: int, n: int, size_a: int, size_b: int) -> int:
    """Modular products of the rank-1 tensor product: forward NTT of the
    2·(size_a + size_b) operand rows, the 4·size_a·size_b products of the
    three column-pair convolutions, inverse NTT of their 3·conv_size rows,
    per prime and ciphertext pair (the 128-bit Garner lift and the exit not
    counted)."""
    conv = size_a + size_b - 1
    return B * P * (ntt_ops(2 * (size_a + size_b), n) + 4 * size_a * size_b * n
                    + ntt_ops(3 * conv, n, True))


def parent_run(prepare, mod, *args, design: str = "parent", **kw):
    """A callable that launches the parent design of a kernel with two
    designs (`fused._product_launch`, `_block_step_launch`, `_tensor_launch`
    or `wide._tensor_wide_launch` and their arguments), or another `design`
    of it, and returns its output; it counts no launch."""
    def run():
        out, launch = prepare(mod, *args, design=design, **kw)
        launch()
        return out
    return run


def check_kernels(cases: dict, parents: dict | None = None) -> dict:
    """Run each case (kernel, plain version, bound[, rows of its step-B digit
    product, or (rows, N) off the product path's N]) once and compare,
    tolerance 0; time the kernel (5 launches), the plain version (1 run)
    and the torch._int_mm yardstick where given;
    where `parents` has the case, the kernel's parent design too (equal,
    tolerance 0, and timed in the same way right after the kernel); emit one
    line per case and return their numbers."""
    import torch

    out = {}
    parents = parents or {}
    for name, (kernel, plain, bnd, *gemm_rows) in cases.items():
        have, want = kernel(), plain()
        torch.cuda.synchronize()
        if isinstance(have, tuple):                 # the tensor step's (d, lin)
            have, want = (torch.cat([x.flatten() for x in t]) for t in (have, want))
        err = int((have.to(torch.int64) - want.to(torch.int64)).abs().max())
        equal = bool(torch.equal(have, want))
        shape = list(have.shape)
        ms = cuda_ms(kernel, 5)
        parent = {}
        if name in parents:
            got = parents[name]()
            if isinstance(got, tuple):
                got = torch.cat([x.flatten() for x in got])
            parent_equal = bool(torch.equal(got, want))
            parent = dict(parent_ms=cuda_ms(parents[name], 5), parent_equal=parent_equal)
            equal = equal and parent_equal
        plain_ms = cuda_ms(plain, 1)
        library_ms = (int_mm_ms(*(gemm_rows[0] if isinstance(gemm_rows[0], tuple)
                                  else (gemm_rows[0], N)), torch.device("cuda"))
                      if gemm_rows else None)
        out[name] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bnd["bound_ms"],
                         bound_by=bnd["bound_by"], library_ms=library_ms)
        emit(phase="kernels", kernel=name, shape=shape, equal=equal, tolerance=0,
             max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms, **parent, **bnd,
             share_of_bound=bnd["bound_ms"] / ms)
        if not equal:
            raise SystemExit(f"kernel {name} (or its parent design) disagrees with its plain "
                             "version")
        del have, want
    return out


def phase_kernels(m, gm, wm) -> dict:
    """Each kernel against its plain version at its path's shapes: the
    product path's on `m`, the gate path's on `gm` at batch GATE_BATCH, the
    wide CKKS mul's on `wm` at batch CKKS_BATCH, the relinearize and
    ckks_rotate paths' on `m` (the ckks configuration's basis) at batch
    CKKS_BATCH; the VMP also at the non-wide CKKS mul's shape on `m` and at
    the "mxu" keyswitch's on a module of its own (the keyswitch path's
    30-bit basis, freed after the phase, so that the paths run as they did
    before these cases); the butterfly kernels also at the CBT paths'
    shapes on `gm` (`cbt_cases`)."""
    import torch

    from poulpy_tpu_torch.backends import fused, ntt, vmp, wide
    from poulpy_tpu_torch.binfhe.blind_rotation import BR_STEPS
    from poulpy_tpu_torch.hal.module import Module

    km = Module(KS_N, 2, 30, m.device)
    wk = Module(KS_N, 4, 30, m.device)

    gen = torch.Generator(device=m.device).manual_seed(5)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    t = m.tables
    # the encryption of the batch transforms [B, 3 limbs, P, N] residues; the
    # product's matrix is [rows 3, ci 2, co 2, psize 4, P, N]
    x = residues(m, (BATCH, 3, NPRIMES, N))
    a_dft = residues(m, (BATCH, 2, 3, NPRIMES, N))
    pmat = residues(m, (DNUM, 2, 2, 4, NPRIMES, N))
    a = ints(-(2**16), 2**16, (BATCH, 2, 3, N))
    # the gate path: the keyswitch [ci 1, k_ct 34: 2 limbs] × KSK [dnum 2, 1,
    # 2, psize 3] with the body added, and one block step of the BRK [block 8,
    # dnum 4, 2, 2, psize 4] on acc [2, 2 limbs]
    gn, gp = gm.n, gm.nprimes
    ks_a = ints(-(2**16), 2**16, (GATE_BATCH, 1, 2, gn))
    ks_body = ints(-(2**16), 2**16, (GATE_BATCH, 2, gn))
    ks_pmat = residues(gm, (2, 1, 2, 3, gp, gn))
    acc = ints(-(2**16), 2**16, (GATE_BATCH, 2, 2, gn))
    brk = residues(gm, (GATE_BLOCK, 4, 2, 2, 4, gp, gn))
    amounts = ints(-gn, gn + 1, (GATE_BATCH, GATE_BLOCK))
    pm_k = fused.pm_kernel_layout(brk, 2)
    rows_used = int(torch.unique(amounts & (2 * gn - 1)).numel())
    # the gate path's chained launch: BR_STEPS block steps of 8 BRK elements each
    chain_brk = residues(gm, (BR_STEPS * GATE_BLOCK, 4, 2, 2, 4, gp, gn))
    chain_amounts = ints(-gn, gn + 1, (GATE_BATCH, BR_STEPS * GATE_BLOCK))
    chain_pm_k = fused.pm_kernel_layout(chain_brk, 2)
    chain_rows_used = int(torch.unique(chain_amounts & (2 * gn - 1)).numel())
    # the wide CKKS mul (2 limbs of 52 bits, tensor key dnum 2, psize 3, P 5):
    # the tensor step on both ciphertexts, then the relinearization of its
    # 2 digits [ci 1, 2 rows] × [rows 2, ci 1, co 2, psize 3] with the 3 lin
    # limbs of each column added, to res_size 2
    c = CKKS_WIDE
    wn, wp, wb = c.n, c.nprimes, CKKS_BATCH
    ca = ints(-(2**51), 2**51, (wb, 2, 2, wn))
    cb = ints(-(2**51), 2**51, (wb, 2, 2, wn))
    digits = ints(-(2**51), 2**51, (wb, 1, c.dnum, wn))
    lin = ints(-(2**51), 2**51, (wb, 2, 3, wn))
    tkey = residues(wm, (c.dnum, 1, 2, 3, wp, wn))
    # a wide keyswitch on a 30-bit basis (P 4, base 2^44): the mask [ci 1, 2
    # limbs] × [rows 3, ci 1, co 2, psize 3] with the 2-limb body in column
    # 0, to 2 limbs; the wide product's runtime-shaped instance
    wk_a = ints(-(2**43), 2**43, (wb, 1, 2, wn))
    wk_body = torch.zeros((wb, 2, 2, wn), dtype=torch.int64, device=m.device)
    wk_body[:, 0] = ints(-(2**43), 2**43, (wb, 2, wn))
    wk_key = residues(wk, (3, 1, 2, 3, wk.nprimes, wn))
    # the relinearize path (ciphertexts of 6 limbs of 17 bits, tensor key k 95
    # dnum 6, psize 6): the tensor step on both ciphertexts, conv 11, then the
    # product of its 6 digits [ci 1, 6 rows] × [rows 6, ci 1, co 2, psize 6]
    # with the 11 linear limbs of each column added, to res_size 12; the
    # ckks_rotate path: the keyswitch of the mask [ci 1, 6 limbs] by the
    # automorphism key [6, 1, 2, 6] with the 6-limb body, to 6 limbs.  Both
    # products split their two output columns over two blocks.
    k, rb, kp = CKKS, CKKS_BATCH, CKKS.nprimes
    ra = ints(-(2**16), 2**16, (rb, 2, 6, N))
    rbb = ints(-(2**16), 2**16, (rb, 2, 6, N))
    rdig = ints(-(2**16), 2**16, (rb, 1, k.dnum, N))
    rlin = ints(-(2**47), 2**47, (rb, 2, 11, N))
    rkey = residues(m, (k.dnum, 1, 2, 6, kp, N))
    rot_a = ints(-(2**16), 2**16, (rb, 1, 6, N))
    rot_body = ints(-(2**16), 2**16, (rb, 6, N))
    # the VMP of the non-wide CKKS mul ([ci 1, 6 digits] × [6, 1, co 2, 6
    # limbs], batch 256) and of the "mxu" keyswitch (30-bit basis, [ci 1, 3
    # limbs] × [3, 1, 2, psize 4], batch KS_BATCH, residues p − 1 in row 0)
    ck_dft = residues(m, (rb, 1, 6, kp, N))
    ck_pmat = residues(m, (k.dnum, 1, 2, 6, kp, N))
    ks_dft = residues(km, (KS_BATCH, 1, 3, km.nprimes, N))
    ks_dft[0] = (torch.tensor(km.basis.primes, device=km.device) - 1).to(torch.int32)[:, None]
    ks_vpmat = residues(km, (KS_DNUM, 1, 2, 4, km.nprimes, N))
    # the NTT at the non-wide CKKS mul's shapes (ckks/ops.py mul, batch 256,
    # as the ckks path's ntt_shapes line counts them: core/operations.py
    # glwe_tensor_product_big transforms both operands [2 columns, 4 limbs]
    # forward and its three terms [conv 7] inverse; the tensor key's
    # keyswitch its digits [1, dnum 6] forward and its sum [co 2, psize 6]
    # inverse)
    ck_ops = residues(m, (rb, 2, 4, kp, N))
    ck_terms = residues(m, (rb, 7, kp, N))
    ck_digits = residues(m, (rb, 1, 6, kp, N))
    ck_sum = residues(m, (rb, 2, 6, kp, N))
    i32, i64 = 4, 8

    def ntt_case(fn, x, inverse):
        return (lambda: fn(t, x), lambda: getattr(ntt, fn.__name__ + "_ref")(t, x),
                bound(2 * x.numel() * i32, ntt_ops(x.numel() // N, N, inverse)))

    cases = {
        "ntt_forward": (lambda: ntt.ntt_forward(t, x), lambda: ntt.ntt_forward_ref(t, x),
                        bound(2 * x.numel() * i32, ntt_ops(x.numel() // N, N))),
        "ntt_inverse": (lambda: ntt.ntt_inverse(t, x), lambda: ntt.ntt_inverse_ref(t, x),
                        bound(2 * x.numel() * i32, ntt_ops(x.numel() // N, N, True))),
        "ntt_forward@ckks_conv": ntt_case(ntt.ntt_forward, ck_ops, False),
        "ntt_inverse@ckks_conv": ntt_case(ntt.ntt_inverse, ck_terms, True),
        "ntt_forward@ckks_keyswitch": ntt_case(ntt.ntt_forward, ck_digits, False),
        "ntt_inverse@ckks_keyswitch": ntt_case(ntt.ntt_inverse, ck_sum, True),
        "vmp": (lambda: vmp.vmp_apply(m, a_dft, pmat),
                lambda: chunked(lambda c: vmp.vmp_apply_ref(m, c, pmat), a_dft),
                bound((a_dft.numel() + pmat.numel() + BATCH * 2 * 4 * NPRIMES * N) * i32,
                      BATCH * 6 * 8 * NPRIMES * N)),
        "vmp@ckks": (lambda: vmp.vmp_apply(m, ck_dft, ck_pmat),
                     lambda: vmp.vmp_apply_ref(m, ck_dft, ck_pmat),
                     bound((ck_dft.numel() + ck_pmat.numel() + rb * 2 * 6 * kp * N) * i32,
                           rb * 6 * 12 * kp * N)),
        "vmp@keyswitch": (lambda: vmp.vmp_apply(km, ks_dft, ks_vpmat),
                          lambda: vmp.vmp_apply_ref(km, ks_dft, ks_vpmat),
                          bound((ks_dft.numel() + ks_vpmat.numel()
                                 + KS_BATCH * 2 * 4 * km.nprimes * N) * i32,
                                KS_BATCH * 3 * 8 * km.nprimes * N)),
        "fused_product": (
            lambda: fused.fused_glwe_product(m, a, pmat, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused.fused_glwe_product_ref(m, c, pmat, 3, BASE2K, BASE2K), a),
            bound(2 * a.numel() * i64 + pmat[:3].numel() * i32, fused_ops(BATCH, 6, 8, NPRIMES, N))),
        "fused_product_small": (
            lambda: fused.fused_glwe_product(gm, ks_a, ks_pmat, 2, BASE2K, BASE2K, small=ks_body),
            lambda: fused.fused_glwe_product_ref(gm, ks_a, ks_pmat, 2, BASE2K, BASE2K,
                                                 small=ks_body),
            bound((ks_a.numel() + ks_body.numel() + GATE_BATCH * 2 * 2 * gn) * i64
                  + ks_pmat.numel() * i32, fused_ops(GATE_BATCH, 2, 6, gp, gn))),
        "br_block_step": (
            lambda: fused.fused_br_block_step(gm, acc, brk, amounts, 2, BASE2K, pm_k),
            lambda: fused.fused_br_block_step_ref(gm, acc, brk, amounts, 2, BASE2K),
            bound(2 * acc.numel() * i64 + amounts.numel() * i64 + pm_k.numel() * i32
                  + rows_used * gp * gn * i32,
                  fused_ops(GATE_BATCH, 4, 8, gp, gn, GATE_BLOCK))),
        "br_block_chain": (
            lambda: fused.fused_br_block_step(gm, acc, chain_brk, chain_amounts, 2, BASE2K,
                                              chain_pm_k, BR_STEPS),
            lambda: fused.fused_br_block_step_ref(gm, acc, chain_brk, chain_amounts, 2, BASE2K,
                                                  BR_STEPS),
            bound(2 * acc.numel() * i64 + chain_amounts.numel() * i64
                  + chain_pm_k.numel() * i32 + chain_rows_used * gp * gn * i32,
                  BR_STEPS * fused_ops(GATE_BATCH, 4, 8, gp, gn, GATE_BLOCK))),
        "wide_tensor": (
            lambda: wide.fused_tensor_product_wide(wm, ca, cb, 3, c.dnum, 3, c.base2k, c.base2k,
                                                   WIDE_OFFSET),
            lambda: wide.fused_tensor_product_wide_ref(wm, ca, cb, 3, c.dnum, 3, c.base2k,
                                                       c.base2k, WIDE_OFFSET),
            bound((ca.numel() + cb.numel() + wb * (c.dnum + 2 * 3) * wn) * i64,
                  tensor_ops(wb, wp, wn, 2, 2))),
        "wide_product": (
            lambda: wide.fused_glwe_product_wide(wm, digits, tkey, 2, c.base2k, c.base2k,
                                                 small=lin),
            lambda: wide.fused_glwe_product_wide_ref(wm, digits, tkey, 2, c.base2k, c.base2k,
                                                     small=lin),
            bound((digits.numel() + lin.numel() + wb * 2 * 2 * wn) * i64 + tkey.numel() * i32,
                  fused_ops(wb, c.dnum, 6, wp, wn))),
        "wide_product@keyswitch30": (
            lambda: wide.fused_glwe_product_wide(wk, wk_a, wk_key, 2, 44, 44, small=wk_body),
            lambda: wide.fused_glwe_product_wide_ref(wk, wk_a, wk_key, 2, 44, 44,
                                                     small=wk_body),
            bound((wk_a.numel() + wk_body.numel() + wb * 2 * 2 * wn) * i64
                  + wk_key[:2].numel() * i32, fused_ops(wb, 2, 6, wk.nprimes, wn))),
        "tensor_product": (
            lambda: fused.fused_tensor_product(m, ra, rbb, 11, k.dnum, k.base2k, k.base2k),
            lambda: fused.fused_tensor_product_ref(m, ra, rbb, 11, k.dnum, k.base2k, k.base2k),
            bound((ra.numel() + rbb.numel() + rb * (k.dnum + 2 * 11) * N) * i64,
                  tensor_ops(rb, kp, N, 6, 6))),
        "fused_product_small64": (
            lambda: fused.fused_glwe_product(m, rdig, rkey, 12, k.base2k, k.base2k, small64=rlin),
            lambda: fused.fused_glwe_product_ref(m, rdig, rkey, 12, k.base2k, k.base2k,
                                                 small64=rlin),
            bound((rdig.numel() + rlin.numel() + rb * 2 * 12 * N) * i64 + rkey.numel() * i32,
                  fused_ops(rb, k.dnum, 12, kp, N))),
        "fused_product_small@ckks_rotate": (
            lambda: fused.fused_glwe_product(m, rot_a, rkey, 6, k.base2k, k.base2k,
                                             small=rot_body),
            lambda: fused.fused_glwe_product_ref(m, rot_a, rkey, 6, k.base2k, k.base2k,
                                                 small=rot_body),
            bound((rot_a.numel() + rot_body.numel() + rb * 2 * 6 * N) * i64
                  + rkey.numel() * i32, fused_ops(rb, 6, 12, kp, N))),
    }
    # the parent designs of the NTT (row 1), of the butterfly kernels (rows
    # 3a, 3b, 3b′, 3c, 4), of the tensor kernels (rows 6, 8), of the wide
    # product (row 7) and of the VMP (row 2), in the same call
    product, step = fused._product_launch, fused._block_step_launch

    def ntt_parent(fn, v):
        return lambda: fn(t, v, design="parent")

    parents = {
        "ntt_forward": ntt_parent(ntt.ntt_forward, x),
        "ntt_inverse": ntt_parent(ntt.ntt_inverse, x),
        "ntt_forward@ckks_conv": ntt_parent(ntt.ntt_forward, ck_ops),
        "ntt_inverse@ckks_conv": ntt_parent(ntt.ntt_inverse, ck_terms),
        "ntt_forward@ckks_keyswitch": ntt_parent(ntt.ntt_forward, ck_digits),
        "ntt_inverse@ckks_keyswitch": ntt_parent(ntt.ntt_inverse, ck_sum),
        "tensor_product": parent_run(fused._tensor_launch, m, ra, rbb, 11, k.dnum, k.base2k,
                                     k.base2k),
        "wide_tensor": parent_run(wide._tensor_wide_launch, wm, ca, cb, 3, c.dnum, 3, c.base2k,
                                  c.base2k, WIDE_OFFSET),
        "wide_product": parent_run(wide._wide_product_launch, wm, digits, tkey, 2, c.base2k,
                                   c.base2k, lin),
        "wide_product@keyswitch30": parent_run(wide._wide_product_launch, wk, wk_a, wk_key, 2,
                                               44, 44, wk_body),
        "vmp": lambda: vmp.vmp_apply(m, a_dft, pmat, design="parent"),
        "vmp@ckks": lambda: vmp.vmp_apply(m, ck_dft, ck_pmat, design="parent"),
        "vmp@keyswitch": lambda: vmp.vmp_apply(km, ks_dft, ks_vpmat, design="parent"),
        "fused_product": parent_run(product, m, a, pmat, 3, BASE2K, BASE2K),
        "fused_product_small": parent_run(product, gm, ks_a, ks_pmat, 2, BASE2K, BASE2K, 1,
                                          ks_body),
        "br_block_step": parent_run(step, gm, acc, brk, amounts, 2, BASE2K, pm_k),
        "fused_product_small64": parent_run(product, m, rdig, rkey, 12, k.base2k, k.base2k, 1,
                                            None, rlin),
        "fused_product_small@ckks_rotate": parent_run(product, m, rot_a, rkey, 6, k.base2k,
                                                      k.base2k, 1, rot_body),
    }
    cbt, cbt_parents = cbt_cases(gm)
    bdd, bdd_parents = bdd_cases(gm)
    timings = check_kernels({**cases, **cbt, **bdd}, {**parents, **cbt_parents, **bdd_parents})
    phase_chain_ab(gm, acc, chain_brk, chain_amounts, chain_pm_k, timings)
    return timings


def phase_chain_ab(gm, acc, brk, amounts, pm_k, timings: dict) -> None:
    """The gate's chained launch (BR_STEPS block steps of GATE_BLOCK key
    elements) beside BR_STEPS single launches of the same key elements, the
    second on the first's output: equal, and timed in turns (chain, singles,
    singles, chain; CUDA events, 5 launches each after a warm-up), beside
    phase 3's bounds of one chain and of one single step."""
    import torch

    from poulpy_tpu_torch.backends import fused
    from poulpy_tpu_torch.binfhe.blind_rotation import BR_STEPS

    keys = [slice(st * GATE_BLOCK, (st + 1) * GATE_BLOCK) for st in range(BR_STEPS)]
    single_amounts = [amounts[:, k].contiguous() for k in keys]

    def chain():
        return fused.fused_br_block_step(gm, acc, brk, amounts, 2, BASE2K, pm_k, BR_STEPS)

    def singles():
        x = acc
        for k, a in zip(keys, single_amounts):
            x = fused.fused_br_block_step(gm, x, brk[k], a, 2, BASE2K, pm_k[k])
        return x

    equal = bool(torch.equal(chain(), singles()))
    runs = {"chain": chain, "singles": singles}
    ms = {name: [] for name in runs}
    for name in ("chain", "singles", "singles", "chain"):
        ms[name].append(cuda_ms(runs[name], 5))
    emit(phase="br_block_chain_ab", batch=GATE_BATCH, block=GATE_BLOCK, steps=BR_STEPS,
         equal=equal, chain_ms=ms["chain"], singles_ms=ms["singles"],
         chain_over_singles=sum(ms["chain"]) / sum(ms["singles"]),
         chain_bound_ms=timings["br_block_chain"]["bound_ms"],
         single_bound_ms=timings["br_block_step"]["bound_ms"])
    if not equal:
        raise SystemExit("the chained block steps differ from single launches")


def cbt_cases(gm) -> tuple:
    """The butterfly kernels of the CBT paths against their plain versions
    (cases, parents for `check_kernels`), on `gm` (get_module(1024, 2, 28))
    with inputs of their own; prints the instance each takes first.  The
    parent of the trace keyswitch's specialised instance is the lazy
    design's runtime-shaped instance, which it replaces at this shape; the
    step's, the unfolded loop body (the product, then the rotation and two
    elementwise ops)."""
    import torch

    from poulpy_tpu_torch.backends import fused
    from poulpy_tpu_torch.binfhe.blind_rotation import BR_STEPS
    from poulpy_tpu_torch.hal.vec_znx import vec_znx_rotate

    # the CBT paths: N 1024, P 2, acc and output 2 limbs, keys psize 4, dnum 3
    phase_instances(gm, "cbt_instances", (("fused_product@cbt", "product", 4, 4, 2, 0),
                                          ("fused_br_step", "step", 4, 4, 2, 0),
                                          ("fused_product_small@cbt", "product", 2, 4, 2, 0),
                                          ("br_block_step@cbt", "block_step", 4, 4, 2,
                                           CBT_BLOCK),
                                          ("br_block_chain@cbt", "block_chain", 4, 4, 2,
                                           BR_STEPS * CBT_BLOCK)))
    gen = torch.Generator(device=gm.device).manual_seed(6)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=gm.device, dtype=torch.int64)

    def residues(shape):
        primes = torch.tensor(gm.basis.primes, device=gm.device)[:, None]
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    gn, gp, i32, i64 = gm.n, gm.nprimes, 4, 8
    # the CBT paths (N 1024, base2k 13) at batch CBT_WIDE_BATCH: one product of
    # the blind rotation, acc [2 columns, 2 limbs, unnormalized] × BRK [dnum 3,
    # 2, 2, psize 4] to 2 limbs, and the step on it (the rotation amounts of
    # mod_switch_2n's output, a strided column, 0, N − 1, N, 2N − 1 and
    # negative ones among them); the trace's keyswitch, the mask [1, 2 limbs]
    # × an automorphism key [3, 1, 2, psize 4] with the 2-limb body, to 2
    # limbs; one block step of 8 BRK elements [8, 3, 2, 2, 4] on acc [2, 2 limbs]
    cb = CBT_WIDE_BATCH
    cbt_acc = ints(-(2**22), 2**22, (cb, 2, 2, gn))
    cbt_pmat = residues((CBT_DNUM_KEY, 2, 2, 4, gp, gn))
    cbt_lwe_2n = ints(-gn, gn + 1, (cb, 3))
    cbt_lwe_2n[:6, 1] = torch.tensor([0, gn - 1, gn, 2 * gn - 1, -1, -gn])
    cbt_a = cbt_lwe_2n[:, 1]
    cbt_step_pm = fused.pm_kernel_layout(cbt_pmat, 2)
    cbt_ks_a = ints(-(2**12), 2**12, (cb, 1, 2, gn))
    cbt_ks_body = ints(-(2**12), 2**12, (cb, 2, gn))
    cbt_ks_pmat = residues((CBT_DNUM_KEY, 1, 2, 4, gp, gn))
    cbt_step_acc = ints(-(2**12), 2**12, (cb, 2, 2, gn))
    cbt_brk = residues((CBT_BLOCK, CBT_DNUM_KEY, 2, 2, 4, gp, gn))
    cbt_amounts = ints(-gn, gn + 1, (cb, CBT_BLOCK))
    cbt_pm_k = fused.pm_kernel_layout(cbt_brk, 2)
    cbt_rows_used = int(torch.unique(cbt_amounts & (2 * gn - 1)).numel())
    # the block-8 path's chained launch: BR_STEPS block steps on the same acc
    chain_brk = residues((BR_STEPS * CBT_BLOCK, CBT_DNUM_KEY, 2, 2, 4, gp, gn))
    chain_amounts = ints(-gn, gn + 1, (cb, BR_STEPS * CBT_BLOCK))
    chain_pm_k = fused.pm_kernel_layout(chain_brk, 2)
    chain_rows_used = int(torch.unique(chain_amounts & (2 * gn - 1)).numel())

    def unfolded():
        tmp = fused.fused_glwe_product(gm, cbt_acc, cbt_pmat, 2, CBT_BASE2K, CBT_BASE2K)
        return cbt_acc + (vec_znx_rotate(cbt_a[:, None, None], tmp) - tmp)

    cases = {
        "fused_product@cbt": (
            lambda: fused.fused_glwe_product(gm, cbt_acc, cbt_pmat, 2, CBT_BASE2K, CBT_BASE2K),
            lambda: fused.fused_glwe_product_ref(gm, cbt_acc, cbt_pmat, 2, CBT_BASE2K,
                                                 CBT_BASE2K),
            bound(2 * cbt_acc.numel() * i64 + cbt_pmat[:2].numel() * i32,
                  fused_ops(cb, 4, 8, gp, gn))),
        "fused_br_step": (
            lambda: fused.fused_br_step(gm, cbt_acc, cbt_pmat, cbt_a, 2, CBT_BASE2K, cbt_step_pm),
            lambda: fused.fused_br_step_ref(gm, cbt_acc, cbt_pmat, cbt_a, 2, CBT_BASE2K),
            bound(2 * cbt_acc.numel() * i64 + cb * i64 + cbt_step_pm.numel() * i32,
                  fused_ops(cb, 4, 8, gp, gn))),
        "fused_product_small@cbt": (
            lambda: fused.fused_glwe_product(gm, cbt_ks_a, cbt_ks_pmat, 2, CBT_BASE2K, CBT_BASE2K,
                                             small=cbt_ks_body),
            lambda: fused.fused_glwe_product_ref(gm, cbt_ks_a, cbt_ks_pmat, 2, CBT_BASE2K,
                                                 CBT_BASE2K, small=cbt_ks_body),
            bound((cbt_ks_a.numel() + cbt_ks_body.numel() + cb * 2 * 2 * gn) * i64
                  + cbt_ks_pmat[:2].numel() * i32, fused_ops(cb, 2, 8, gp, gn))),
        "br_block_step@cbt": (
            lambda: fused.fused_br_block_step(gm, cbt_step_acc, cbt_brk, cbt_amounts, 2,
                                              CBT_BASE2K, cbt_pm_k),
            lambda: fused.fused_br_block_step_ref(gm, cbt_step_acc, cbt_brk, cbt_amounts, 2,
                                                  CBT_BASE2K),
            bound(2 * cbt_step_acc.numel() * i64 + cbt_amounts.numel() * i64
                  + cbt_pm_k.numel() * i32 + cbt_rows_used * gp * gn * i32,
                  fused_ops(cb, 4, 8, gp, gn, CBT_BLOCK))),
        "br_block_chain@cbt": (
            lambda: fused.fused_br_block_step(gm, cbt_step_acc, chain_brk, chain_amounts, 2,
                                              CBT_BASE2K, chain_pm_k, BR_STEPS),
            lambda: fused.fused_br_block_step_ref(gm, cbt_step_acc, chain_brk, chain_amounts, 2,
                                                  CBT_BASE2K, BR_STEPS),
            bound(2 * cbt_step_acc.numel() * i64 + chain_amounts.numel() * i64
                  + chain_pm_k.numel() * i32 + chain_rows_used * gp * gn * i32,
                  BR_STEPS * fused_ops(cb, 4, 8, gp, gn, CBT_BLOCK))),
    }
    product = fused._product_launch
    parents = {
        "fused_product@cbt": parent_run(product, gm, cbt_acc, cbt_pmat, 2, CBT_BASE2K,
                                        CBT_BASE2K),
        "fused_br_step": unfolded,
        "fused_product_small@cbt": parent_run(product, gm, cbt_ks_a, cbt_ks_pmat, 2, CBT_BASE2K,
                                              CBT_BASE2K, 1, cbt_ks_body, design="runtime"),
        "br_block_step@cbt": parent_run(fused._block_step_launch, gm, cbt_step_acc, cbt_brk,
                                        cbt_amounts, 2, CBT_BASE2K, cbt_pm_k),
    }
    return cases, parents


def phase_instances(gm, phase: str, rows: tuple) -> None:
    """The instance each butterfly kernel takes at its path's shape (N and P
    of `gm`, two output columns; `rows`: name, launch ("product",
    "step" or "block_step", as `fused.LAZY_SHAPES`' keys, or "block_chain",
    a chain of block steps), KK, psize, res_size, key elements of the launch,
    0 but for the block step and the chain): specialised where its
    `fused.LAZY_SHAPES` key has one, else the runtime-shaped instance of
    the lazy design."""
    from poulpy_tpu_torch.backends import fused

    out = {}
    for name, kind, kk, psize, res, block in rows:
        launch = "block_step" if kind == "block_chain" else kind
        lay = fused.butterfly_layout(kk, 2, psize, gm.nprimes, gm.n, res, block=block,
                                     split=launch != "block_step",
                                     step=kind in ("step", "block_chain"))
        shape = (launch, gm.log_n, kk, lay.cpb * psize, gm.nprimes, psize, res)
        out[name] = dict(design=lay.kind, lazy_shape=list(shape), cols_per_block=lay.cpb,
                         ciphertexts_per_block=lay.tile, smem=lay.smem,
                         instance="specialised" if shape in fused.LAZY_SHAPES
                         else "runtime-shaped")
    emit(phase=phase, **out)


def phase_kernels_mxu(m, km, gm) -> dict:
    """The MXU route's kernels against their plain versions: the product
    path's shapes on `m`, the fused product with the body at the keyswitch
    path's on `km`, and the block step at the gate path's on `gm`; on `gm`
    too, the shapes the route paths launch first: the fused MXU product and
    its `small` form at the CBT's, the "mxu" route's four launches at the
    CBT trace's keyswitch, the block step at fheuint_prepare's block 7
    (inputs of their own)."""
    import torch

    from poulpy_tpu_torch.backends import fused, fused_mxu, mxu, vmp

    gen = torch.Generator(device=m.device).manual_seed(6)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    t = m.tables
    a = ints(-(2**16), 2**16, (BATCH, 2, 3, N))
    pmat = residues(m, (DNUM, 2, 2, 4, NPRIMES, N))
    # the MXU route of the product path (B 16384): the forward of the 6 input
    # rows of each ciphertext with 3 digit planes (a), the inverse of its 8
    # output rows, the exit of its [co 2, psize 4] residues, the fused MXU
    # product; and the fused MXU product with the body at the keyswitch
    # path's shape (30-bit basis, mask [ci 1, 3 limbs] × [3, 1, 2, psize 4],
    # body 3 limbs, batch KS_BATCH)
    kp = km.nprimes
    y_mxu = residues(m, (BATCH * 8, NPRIMES, N))
    x_exit = residues(m, (BATCH, 2, 4, NPRIMES, N))
    ks_mask = ints(-(2**16), 2**16, (KS_BATCH, 1, 3, N))
    ks_body3 = ints(-(2**16), 2**16, (KS_BATCH, 3, N))
    ks_key = residues(km, (KS_DNUM, 1, 2, 4, kp, N))
    # the block step at the gate shape (acc [2, 2 limbs] at N 1024, BRK [block
    # 8, dnum 4, 2, 2, psize 4], P 2, batch GATE_BATCH), the key in σ order
    gn, gp = gm.n, gm.nprimes
    acc = ints(-(2**16), 2**16, (GATE_BATCH, 2, 2, gn))
    brk = residues(gm, (GATE_BLOCK, 4, 2, 2, 4, gp, gn))
    amounts = ints(-gn, gn + 1, (GATE_BATCH, GATE_BLOCK))
    pm_k = fused.pm_kernel_layout(brk[..., mxu.sigma_index(gm.tables)], 2)
    rows_used = int(torch.unique(amounts & (2 * gn - 1)).numel())
    n2 = split(N)[1]
    garner_products = NPRIMES * (NPRIMES - 1) // 2 + NPRIMES - 1   # per limb
    i32, i64 = 4, 8
    # the "mxu" keyswitch (30-bit basis, batch KS_BATCH): the forward of its
    # 3 mask limbs (3 planes, limbs past int32 in row 0), the inverse of its 8
    # output rows (residues p − 1 in row 0), the exit of its [co 2, psize 4]
    # residues with the 3-limb body
    x_ks = ints(-(2**22), 2**22, (KS_BATCH, 1, 3, N))
    x_ks[0, 0, 0, :4] = torch.tensor([-(2**63), 2**63 - 1, 2**31, -(2**31) - 1])
    y_ks = residues(km, (KS_BATCH * 8, kp, N))
    y_ks[0] = (torch.tensor(km.basis.primes, device=km.device) - 1).to(torch.int32)[:, None]
    exit_ks = residues(km, (KS_BATCH, 2, 4, kp, N))
    exit_ks[0] = (torch.tensor(km.basis.primes, device=km.device) - 1).to(torch.int32)[:, None]
    body_ks = ints(-(2**16), 2**16, (KS_BATCH, 3, N))
    # first launches at the CBT's and the BDD prepare's shapes (N 1024, P 2,
    # runtime-shaped instances): the blind rotation's fused MXU product, acc
    # [2 columns, 2 limbs, unnormalized] × BRK [dnum 3, 2, 2, psize 4] to 2
    # limbs, base2k 13, batch CBT_WIDE_BATCH; the trace's keyswitch, the mask
    # [1, 2 limbs] × an automorphism key [3, 1, 2, psize 4] with the 2-limb
    # body, through the fused MXU product and through the "mxu" route's four
    # launches (forward with 3 digit planes: in_bits 19, VMP of the σ-order
    # residues, inverse of the 8 output rows, Garner exit with the body);
    # fheuint_prepare's block step at block 7, acc [2, 3 limbs] × BRK [7, dnum
    # 4, 2, 2, psize 4] to 3 limbs, base2k 15, batch BDD_WIDTH
    cb, gt = CBT_WIDE_BATCH, gm.tables
    cbt_acc = ints(-(2**22), 2**22, (cb, 2, 2, gn))
    cbt_pmat = residues(gm, (CBT_DNUM_KEY, 2, 2, 4, gp, gn))
    cbt_mask = ints(-(2**12), 2**12, (cb, 1, 2, gn))
    cbt_body = ints(-(2**12), 2**12, (cb, 2, gn))
    cbt_key = residues(gm, (CBT_DNUM_KEY, 1, 2, 4, gp, gn))
    cbt_res = residues(gm, (cb, 1, 2, gp, gn))
    cbt_y = residues(gm, (cb * 8, gp, gn))
    cbt_exit = residues(gm, (cb, 2, 4, gp, gn))
    bw = BDD_WIDTH
    bdd_acc = ints(-(2**14), 2**14, (bw, 2, 3, gn))
    bdd_brk = residues(gm, (BDD_BLOCK, BDD_DNUM_CBT, 2, 2, 4, gp, gn))
    bdd_amounts = ints(-gn, gn + 1, (bw, BDD_BLOCK))
    bdd_pm_k = fused.pm_kernel_layout(bdd_brk[..., mxu.sigma_index(gt)], 3)
    bdd_rows_used = int(torch.unique(bdd_amounts & (2 * gn - 1)).numel())
    gn2 = split(gn)[1]

    def parent(prepare, *args):
        def run():
            out, launch = prepare(*args, design="parent")
            launch()
            return out
        return run

    parents = {"mxu_forward": parent(mxu._forward_launch, t, a, 3),
               "mxu_forward@keyswitch": parent(mxu._forward_launch, km.tables, x_ks, 3),
               "mxu_inverse": parent(mxu._inverse_launch, t, y_mxu),
               "mxu_inverse@keyswitch": parent(mxu._inverse_launch, km.tables, y_ks),
               "garner_exit": parent(fused._exit_launch, m, x_exit, 4, 3, BASE2K, BASE2K),
               "garner_exit@keyswitch": parent(fused._exit_launch, km, exit_ks, 4, 3, BASE2K,
                                               BASE2K, body_ks),
               "mxu_forward@cbt_trace": parent(mxu._forward_launch, gt, cbt_mask, 3),
               "mxu_inverse@cbt_trace": parent(mxu._inverse_launch, gt, cbt_y),
               "garner_exit@cbt_trace": parent(fused._exit_launch, gm, cbt_exit, 4, 2,
                                               CBT_BASE2K, CBT_BASE2K, cbt_body)}
    return check_kernels({
        "mxu_forward": (
            lambda: mxu.mxu4_forward_limbs(t, a, 3),
            lambda: chunked(lambda c: mxu.mxu4_forward_limbs_ref(t, c, 3), a),
            bound(a.numel() * (i64 + NPRIMES * i32), a.numel() * NPRIMES,
                  mxu_macs(BATCH * 6, NPRIMES, N, 3)),
            BATCH * 6 * NPRIMES * n2),
        "mxu_forward@keyswitch": (
            lambda: mxu.mxu4_forward_limbs(km.tables, x_ks, 3),
            lambda: mxu.mxu4_forward_limbs_ref(km.tables, x_ks, 3),
            bound(x_ks.numel() * (i64 + kp * i32), x_ks.numel() * kp,
                  mxu_macs(KS_BATCH * 3, kp, N, 3)),
            KS_BATCH * 3 * kp * n2),
        "mxu_inverse": (
            lambda: mxu.mxu4_inverse(t, y_mxu),
            lambda: chunked(lambda c: mxu.mxu4_inverse_ref(t, c), y_mxu),
            bound(2 * y_mxu.numel() * i32, y_mxu.numel(), mxu_macs(BATCH * 8, NPRIMES, N)),
            BATCH * 8 * NPRIMES * n2),
        "mxu_inverse@keyswitch": (
            lambda: mxu.mxu4_inverse(km.tables, y_ks),
            lambda: mxu.mxu4_inverse_ref(km.tables, y_ks),
            bound(2 * y_ks.numel() * i32, y_ks.numel(), mxu_macs(KS_BATCH * 8, kp, N)),
            KS_BATCH * 8 * kp * n2),
        "garner_exit": (
            lambda: fused.garner_exit(m, x_exit, 4, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused.garner_exit_ref(m, c, 4, 3, BASE2K, BASE2K), x_exit),
            bound(x_exit.numel() * i32 + BATCH * 2 * 3 * N * i64, BATCH * 2 * 4 * N * garner_products)),
        "garner_exit@keyswitch": (
            lambda: fused.garner_exit(km, exit_ks, 4, 3, BASE2K, BASE2K, body_ks),
            lambda: fused.garner_exit_ref(km, exit_ks, 4, 3, BASE2K, BASE2K, body_ks),
            bound(exit_ks.numel() * i32 + (body_ks.numel() + KS_BATCH * 2 * 3 * N) * i64,
                  KS_BATCH * 2 * 4 * N * garner_products)),
        "fused_mxu_product": (
            lambda: fused_mxu.fused_mxu_glwe_product(m, a, pmat, 3, BASE2K, BASE2K),
            lambda: chunked(lambda c: fused_mxu.fused_mxu_glwe_product_ref(m, c, pmat, 3, BASE2K,
                                                                           BASE2K), a),
            bound(2 * a.numel() * i64 + pmat[:3].numel() * i32,
                  BATCH * NPRIMES * (6 * 8 + 6 + 8) * N,
                  mxu_macs(BATCH * 6, NPRIMES, N) + mxu_macs(BATCH * 8, NPRIMES, N)),
            BATCH * (6 + 8) * NPRIMES * n2),
        "fused_mxu_product_small": (
            lambda: fused_mxu.fused_mxu_glwe_product(km, ks_mask, ks_key, 3, BASE2K, BASE2K,
                                                     small=ks_body3),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(km, ks_mask, ks_key, 3, BASE2K, BASE2K,
                                                         small=ks_body3),
            bound((ks_mask.numel() + ks_body3.numel() + KS_BATCH * 2 * 3 * N) * i64
                  + ks_key.numel() * i32, KS_BATCH * kp * (3 * 8 + 3 + 8) * N,
                  mxu_macs(KS_BATCH * 3, kp, N) + mxu_macs(KS_BATCH * 8, kp, N)),
            KS_BATCH * (3 + 8) * kp * n2),
        # modular products: the block's VMP and x-power factor and the
        # twiddles of 4 forward and 8 inverse rows (the transforms are int8
        # multiply-adds), per prime and ciphertext
        "fused_mxu_br_block_step": (
            lambda: fused_mxu.fused_mxu_br_block_step(gm, acc, brk, amounts, 2, BASE2K, pm_k),
            lambda: fused_mxu.fused_mxu_br_block_step_ref(gm, acc, brk, amounts, 2, BASE2K),
            bound(2 * acc.numel() * i64 + amounts.numel() * i64 + pm_k.numel() * i32
                  + rows_used * gp * gn * i32,
                  GATE_BATCH * gp * GATE_BLOCK * (4 * 8 + 8) * gn + GATE_BATCH * gp * 12 * gn,
                  mxu_macs(GATE_BATCH * 4, gp, gn) + mxu_macs(GATE_BATCH * 8, gp, gn)),
            GATE_BATCH * (4 + 8) * gp * split(gn)[1]),
        "fused_mxu_product@cbt": (
            lambda: fused_mxu.fused_mxu_glwe_product(gm, cbt_acc, cbt_pmat, 2, CBT_BASE2K,
                                                     CBT_BASE2K),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(gm, cbt_acc, cbt_pmat, 2, CBT_BASE2K,
                                                         CBT_BASE2K),
            bound(2 * cbt_acc.numel() * i64 + cbt_pmat[:2].numel() * i32,
                  cb * gp * (4 * 8 + 4 + 8) * gn,
                  mxu_macs(cb * 4, gp, gn) + mxu_macs(cb * 8, gp, gn)),
            (cb * (4 + 8) * gp * gn2, gn)),
        "fused_mxu_product_small@cbt": (
            lambda: fused_mxu.fused_mxu_glwe_product(gm, cbt_mask, cbt_key, 2, CBT_BASE2K,
                                                     CBT_BASE2K, small=cbt_body),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(gm, cbt_mask, cbt_key, 2, CBT_BASE2K,
                                                         CBT_BASE2K, small=cbt_body),
            bound((cbt_mask.numel() + cbt_body.numel() + cb * 2 * 2 * gn) * i64
                  + cbt_key[:2].numel() * i32, cb * gp * (2 * 8 + 2 + 8) * gn,
                  mxu_macs(cb * 2, gp, gn) + mxu_macs(cb * 8, gp, gn)),
            (cb * (2 + 8) * gp * gn2, gn)),
        "fused_mxu_br_block_step@fheuint_prepare": (
            lambda: fused_mxu.fused_mxu_br_block_step(gm, bdd_acc, bdd_brk, bdd_amounts, 3,
                                                      BDD_BASE2K, bdd_pm_k),
            lambda: fused_mxu.fused_mxu_br_block_step_ref(gm, bdd_acc, bdd_brk, bdd_amounts, 3,
                                                          BDD_BASE2K),
            bound(2 * bdd_acc.numel() * i64 + bdd_amounts.numel() * i64
                  + bdd_pm_k.numel() * i32 + bdd_rows_used * gp * gn * i32,
                  bw * gp * BDD_BLOCK * (6 * 8 + 8) * gn + bw * gp * 14 * gn,
                  mxu_macs(bw * 6, gp, gn) + mxu_macs(bw * 8, gp, gn)),
            (bw * (6 + 8) * gp * gn2, gn)),
        "mxu_forward@cbt_trace": (
            lambda: mxu.mxu4_forward_limbs(gt, cbt_mask, 3),
            lambda: mxu.mxu4_forward_limbs_ref(gt, cbt_mask, 3),
            bound(cbt_mask.numel() * (i64 + gp * i32), cbt_mask.numel() * gp,
                  mxu_macs(cb * 2, gp, gn, 3)),
            (cb * 2 * gp * gn2, gn)),
        "vmp@cbt_trace": (
            lambda: vmp.vmp_apply(gm, cbt_res, cbt_key[..., mxu.sigma_index(gt)]),
            lambda: vmp.vmp_apply_ref(gm, cbt_res, cbt_key[..., mxu.sigma_index(gt)]),
            bound((cbt_res.numel() + cbt_key[:2].numel() + cb * 2 * 4 * gp * gn) * i32,
                  cb * 2 * 8 * gp * gn)),
        "mxu_inverse@cbt_trace": (
            lambda: mxu.mxu4_inverse(gt, cbt_y),
            lambda: mxu.mxu4_inverse_ref(gt, cbt_y),
            bound(2 * cbt_y.numel() * i32, cbt_y.numel(), mxu_macs(cb * 8, gp, gn)),
            (cb * 8 * gp * gn2, gn)),
        "garner_exit@cbt_trace": (
            lambda: fused.garner_exit(gm, cbt_exit, 4, 2, CBT_BASE2K, CBT_BASE2K, cbt_body),
            lambda: fused.garner_exit_ref(gm, cbt_exit, 4, 2, CBT_BASE2K, CBT_BASE2K, cbt_body),
            bound(cbt_exit.numel() * i32 + (cbt_body.numel() + cb * 2 * 2 * gn) * i64,
                  cb * 2 * 4 * gn * garner_products)),
    }, parents)


def fused_mxu_cases(m, km, gm) -> dict:
    """The fused MXU kernel's three launches at their paths' shapes, on
    inputs of their own: name → (module, arguments of `_product_launch` or
    `_block_step_launch`, block_step)."""
    import torch

    from poulpy_tpu_torch.backends import fused, mxu

    gen = torch.Generator(device=m.device).manual_seed(7)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        return (ints(1 << 62, shape).abs() % primes).to(torch.int32)

    gn = gm.n
    brk = residues(gm, (GATE_BLOCK, 4, 2, 2, 4, gm.nprimes, gn))
    return {
        "fused_mxu_product": (m, (ints(2**16, (BATCH, 2, 3, N)),
                                  residues(m, (DNUM, 2, 2, 4, NPRIMES, N)), 3, BASE2K, BASE2K,
                                  None, None), False),
        "fused_mxu_product_small": (km, (ints(2**16, (KS_BATCH, 1, 3, N)),
                                         residues(km, (KS_DNUM, 1, 2, 4, km.nprimes, N)), 3,
                                         BASE2K, BASE2K, ints(2**16, (KS_BATCH, 3, N)), None),
                                    False),
        "fused_mxu_br_block_step": (gm, (ints(2**16, (GATE_BATCH, 2, 2, gn)), brk,
                                         ints(3 * gn, (GATE_BATCH, GATE_BLOCK)), 2, BASE2K,
                                         fused.pm_kernel_layout(
                                             brk[..., mxu.sigma_index(gm.tables)], 2)), True),
    }


def butterfly_cases(m, km, gm) -> dict:
    """The butterfly kernels' five launches at their paths' shapes, on inputs
    of their own: name → (module, arguments of `fused._product_launch` or
    `fused._block_step_launch`, block_step).  The product path's (3a), the
    keyswitch path's body add (30-bit basis, 3b), the rotation's column-split
    body add (3b′) and the relinearization's small64 add (3c) at batch 256,
    the gate's block step at batch GATE_BATCH (4)."""
    import torch

    from poulpy_tpu_torch.backends import fused

    gen = torch.Generator(device=m.device).manual_seed(9)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device=m.device, dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        return (ints(1 << 62, shape).abs() % primes).to(torch.int32)

    gn, kb, rb = gm.n, CKKS.base2k, CKKS_BATCH
    brk = residues(gm, (GATE_BLOCK, 4, 2, 2, 4, gm.nprimes, gn))
    rkey = residues(m, (CKKS.dnum, 1, 2, 6, CKKS.nprimes, N))
    return {
        "fused_product": (m, (ints(2**16, (BATCH, 2, 3, N)),
                              residues(m, (DNUM, 2, 2, 4, NPRIMES, N)), 3, BASE2K, BASE2K),
                          False),
        "fused_product_small": (km, (ints(2**16, (KS_BATCH, 1, 3, N)),
                                     residues(km, (KS_DNUM, 1, 2, 4, km.nprimes, N)), 3, BASE2K,
                                     BASE2K, 1, ints(2**16, (KS_BATCH, 3, N))), False),
        "fused_product_small@ckks_rotate": (m, (ints(2**16, (rb, 1, 6, N)), rkey, 6, kb, kb, 1,
                                                ints(2**16, (rb, 6, N))), False),
        "fused_product_small64": (m, (ints(2**16, (rb, 1, CKKS.dnum, N)), rkey, 12, kb, kb, 1,
                                      None, ints(2**47, (rb, 2, 11, N))), False),
        "br_block_step": (gm, (ints(2**16, (GATE_BATCH, 2, 2, gn)), brk,
                               ints(3 * gn, (GATE_BATCH, GATE_BLOCK)), 2, BASE2K,
                               fused.pm_kernel_layout(brk, 2)), True),
    }


def cbt_stage_cases(gm) -> dict:
    """The butterfly kernels at the CBT's shapes for the stage clock, as
    `butterfly_cases`: the blind rotation's step and the trace's keyswitch
    with the body (batch CBT_WIDE_BATCH), the product that the step folds
    (runtime-shaped: "runtime" and "lazy" are one instance), beside the
    gate's keyswitch (GateKsShape, batch GATE_BATCH) for comparison."""
    import torch

    gen = torch.Generator(device=gm.device).manual_seed(10)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device=gm.device, dtype=torch.int64)

    def residues(shape):
        primes = torch.tensor(gm.basis.primes, device=gm.device)[:, None]
        return (ints(1 << 62, shape).abs() % primes).to(torch.int32)

    gn, gp, cb = gm.n, gm.nprimes, CBT_WIDE_BATCH
    key = residues((CBT_DNUM_KEY, 2, 2, 4, gp, gn))
    return {
        "fused_product_small@gate": (gm, (ints(2**16, (GATE_BATCH, 1, 2, gn)),
                                          residues((2, 1, 2, 3, gp, gn)), 2, BASE2K, BASE2K, 1,
                                          ints(2**16, (GATE_BATCH, 2, gn))), False),
        "fused_product@cbt": (gm, (ints(2**22, (cb, 2, 2, gn)), key, 2, CBT_BASE2K, CBT_BASE2K),
                              False),
        "fused_br_step@cbt": (gm, (ints(2**22, (cb, 2, 2, gn)), key, 2, CBT_BASE2K, CBT_BASE2K,
                                   1, None, None, ints(2 * gn, (cb,))), False),
        "fused_product_small@cbt": (gm, (ints(2**12, (cb, 1, 2, gn)),
                                         residues((CBT_DNUM_KEY, 1, 2, 4, gp, gn)), 2,
                                         CBT_BASE2K, CBT_BASE2K, 1, ints(2**12, (cb, 2, gn))),
                                    False),
    }


def phase_stages(backend, cases: dict, designs: tuple) -> None:
    """A fused kernel's stage clock at the paths' shapes, per design
    (`backend`: `fused_mxu`, or `fused` for the butterfly kernels): the
    kernel's time (CUDA events, 5 launches of the untimed instance), then
    one launch of the timed instance, whose output must equal the untimed
    one's; per stage the SM cycles per block (mean over blocks), its share
    of a block's cycles, and that share of the kernel's time."""
    import torch

    for name, (mod, args, block_step) in cases.items():
        prepare = backend._block_step_launch if block_step else backend._product_launch
        for design in designs:
            out, launch = prepare(mod, *args, design=design)
            ms = cuda_ms(launch, 5)
            want = out.clone()
            timed_out, stamps = backend.stage_cycles(mod, *args, block_step=block_step,
                                                     design=design)
            torch.cuda.synchronize()
            if not torch.equal(timed_out, want):
                raise SystemExit(f"stages: the timed {design} {name} disagrees with the untimed")
            cycles = stamps.to(torch.float64).mean(0).tolist()
            total = sum(cycles)
            emit(phase="stages", kernel=name, design=design, ms=ms, blocks=stamps.shape[0],
                 block_cycles=total,
                 stages={st: dict(cycles=c, share=c / total, ms=ms * c / total)
                         for st, c in zip(backend.STAGES, cycles)})
            del out, want, timed_out


def transform_cases(m, km) -> dict:
    """The MXU transforms at the "mxu" route's shapes, on inputs of their
    own: name → (tables, input, forward).  The forward of the product path's
    [B·6 rows, N 2048] limbs (3 planes) on the 28-bit basis and of the
    keyswitch path's [KS_BATCH·3, N] on the 30-bit basis (limbs past int32 in
    its first row); the inverse of the product path's [B·8 rows, P 2, N] and
    of the keyswitch path's [KS_BATCH·8, P 2, N] (residues p − 1 in its first
    row)."""
    import torch

    gen = torch.Generator(device=m.device).manual_seed(10)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device=mod.device)[:, None]
        x = torch.randint(0, 1 << 62, shape, generator=gen, device=mod.device, dtype=torch.int64)
        return (x % primes).to(torch.int32)

    def limbs(rows):
        return torch.randint(-(2**22), 2**22, (rows, N), generator=gen, device=m.device,
                             dtype=torch.int64)

    x_ks = limbs(KS_BATCH * 3)
    x_ks[0, :4] = torch.tensor([-(2**63), 2**63 - 1, 2**31, -(2**31) - 1])
    y_ks = residues(km, (KS_BATCH * 8, km.nprimes, N))
    y_ks[0] = (torch.tensor(km.basis.primes, device=km.device) - 1).to(torch.int32)[:, None]
    return {"mxu_forward": (m.tables, limbs(BATCH * 6), True),
            "mxu_forward@keyswitch": (km.tables, x_ks, True),
            "mxu_inverse": (m.tables, residues(m, (BATCH * 8, NPRIMES, N)), False),
            "mxu_inverse@keyswitch": (km.tables, y_ks, False)}


def phase_transform_stages(cases: dict, designs: tuple) -> None:
    """The MXU transforms' stage clocks, per design: the kernel's time (CUDA
    events, 5 launches), then one launch of its TIMED instance, whose output
    must equal the untimed one's and the plain version's; per stage the SM
    cycles per block (mean over blocks; the wg designs' block walks many
    tasks) and per row (summed over blocks), its share, and that share of
    the time.  The forwards take 3 digit planes, as the route's."""
    import torch

    from poulpy_tpu_torch.backends import mxu

    for name, (t, x, forward) in cases.items():
        if forward:
            want = chunked(lambda c: mxu.mxu4_forward_limbs_ref(t, c, 3), x)
            stages = mxu.FWD_STAGES
        else:
            want = chunked(lambda c: mxu.mxu4_inverse_ref(t, c), x)
            stages = mxu.STAGES
        for design in designs:
            if forward:
                out, launch = mxu._forward_launch(t, x, 3, design)
            else:
                out, launch = mxu._inverse_launch(t, x, design)
            ms = cuda_ms(launch, 5)
            timed_out, stamps = mxu.stage_cycles(t, x, design, forward=forward, nd_in=3)
            torch.cuda.synchronize()
            if not (torch.equal(out, want) and torch.equal(timed_out, want)):
                raise SystemExit(f"stages: the {design} {name} disagrees with its plain version")
            cycles = stamps.to(torch.float64).mean(0).tolist()
            total = sum(cycles)
            rows = x.shape[0]
            emit(phase="stages", kernel=name, design=design, ms=ms, blocks=stamps.shape[0],
                 rows=rows, block_cycles=total,
                 stages={st: dict(cycles=c, per_row=c * stamps.shape[0] / rows, share=c / total,
                                  ms=ms * c / total)
                         for st, c in zip(stages[design], cycles)})
            del out, timed_out
        del want


def tensor_cases(m, wm) -> dict:
    """The tensor kernels at their paths' shapes, on inputs of their own:
    name → (launch preparer, arguments, the lazy design's task variants).
    The relinearize path's tensor product (batch 256, 6 + 6 limbs of 17
    bits, conv 11, dnum 6) and the CKKS-wide mul's (batch 256, 2 + 2 limbs of
    52 bits, conv 3, dnum 2, lin 3, offset 13), whose lazy design is also
    timed with a pair per task."""
    import torch

    from poulpy_tpu_torch.backends import fused, wide

    gen = torch.Generator(device=m.device).manual_seed(12)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device=m.device, dtype=torch.int64)

    k, c = CKKS, CKKS_WIDE
    return {
        "tensor_product": (fused._tensor_launch, m,
                           (ints(2**16, (CKKS_BATCH, 2, 6, N)), ints(2**16, (CKKS_BATCH, 2, 6, N)),
                            11, k.dnum, k.base2k, k.base2k), (None,)),
        "wide_tensor": (wide._tensor_wide_launch, wm,
                        (ints(2**51, (CKKS_BATCH, 2, 2, c.n)), ints(2**51, (CKKS_BATCH, 2, 2, c.n)),
                         3, c.dnum, 3, c.base2k, c.base2k, WIDE_OFFSET), (None, 1)),
    }


def wide_product_cases(wm) -> dict:
    """The wide product at the CKKS-wide mul's relinearization (batch 256,
    its 2 digits of 52 bits against the tensor key, co 2, psize 3, the 3
    linear limbs of each column added, 2 limbs out), on inputs of its own:
    name → (launch preparer, module, arguments, no task variants)."""
    import torch

    from poulpy_tpu_torch.backends import wide

    gen = torch.Generator(device=wm.device).manual_seed(13)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device=wm.device, dtype=torch.int64)

    c = CKKS_WIDE
    primes = torch.tensor(wm.basis.primes, device=wm.device)[:, None]
    key = (ints(1 << 62, (c.dnum, 1, 2, 3, c.nprimes, c.n)).abs() % primes).to(torch.int32)
    return {"wide_product": (wide._wide_product_launch, wm,
                             (ints(2**51, (CKKS_BATCH, 1, c.dnum, c.n)), key, 2, c.base2k,
                              c.base2k, ints(2**51, (CKKS_BATCH, 2, 3, c.n))), (None,))}


def phase_tensor_stages(cases: dict, stages: tuple | None = None,
                        variant: str | None = "pairs") -> None:
    """The stage clocks of the kernels with a lazy and a parent design (the
    tensor kernels, whose launch preparer takes the lazy task's `variant`
    keyword `pairs`; the wide product, `variant` None), per design and, for
    the lazy one, per task variant: the kernel's time (CUDA events, 5 launches),
    then one launch of its TIMED instance, whose output must equal the
    untimed one's and the parent design's; per stage (`stages`, the tensor
    kernels' by default) the SM cycles per block (mean over blocks), its
    share, and that share of the time."""
    import torch

    from poulpy_tpu_torch.backends import fused

    stages = stages or fused.TENSOR_STAGES

    def flat(out):
        return torch.cat([x.flatten() for x in out]) if isinstance(out, tuple) else out

    for name, (prepare, mod, args, variants) in cases.items():
        want = None
        for design, v in [("parent", None)] + [("lazy", v) for v in variants]:
            kw = {variant: v} if variant else {}
            out, launch = prepare(mod, *args, design=design, **kw)
            ms = cuda_ms(launch, 5)
            have = flat(out)
            timed_out, launch_timed = prepare(mod, *args, design=design, **kw)
            stamps = launch_timed(timed=True)
            torch.cuda.synchronize()
            timed = flat(timed_out)
            want = have if want is None else want
            if not (torch.equal(have, want) and torch.equal(timed, want)):
                raise SystemExit(f"stages: the {design} {name} ({variant} {v}) disagrees")
            cycles = stamps.to(torch.float64).mean(0).tolist()
            total = sum(cycles)
            emit(phase="stages", kernel=name, design=design, **kw, ms=ms,
                 blocks=stamps.shape[0], block_cycles=total,
                 stages={st: dict(cycles=c, share=c / total, ms=ms * c / total)
                         for st, c in zip(stages, cycles)})
            del out, have, timed_out, timed
        del want


def phase_ptxas() -> None:
    """What ptxas reported (`-Xptxas -v` in the build's nvcc.log) for the
    Garner exit's instances, the MXU transforms' wg designs, the tensor
    kernels' instances, both designs of the NTT and fused_product_tile.cu's
    kernels: registers, stack frame and spills per entry function."""
    import re

    from poulpy_tpu_torch.backends import _lib

    log = (Path(_lib.build_info["path"]).parent / "nvcc.log").read_text()
    entries = re.findall(r"Compiling entry function '(\w+)'.*?\n(?:.*?\n)*?.*?(\d+) bytes stack "
                         r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n.*?Used "
                         r"(\d+) registers", log)
    for name, stack, stores, loads, regs in entries:
        if any(k in name for k in ("garner_exit", "mxu_forward_wg", "mxu_inverse_wg", "tensor",
                                   "ntt_kernel", "ntt_lazy", "wide_product", "product_tile",
                                   "br_step")):
            emit(phase="ptxas", entry=name, registers=int(regs), stack_frame=int(stack),
                 spill_stores=int(stores), spill_loads=int(loads))


def host_ms(fn, reps: int) -> float:
    """Mean milliseconds of `fn()` on the host clock over `reps` runs after
    one warm-up."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def bigint_product(a, b) -> list:
    """The exact negacyclic product of two int64 rows, in Python ints."""
    import numpy as np

    full = np.convolve(a.astype(object), b.astype(object))
    return [int(v) for v in full[: a.size] - np.append(full[a.size:], 0)]


def native_cases() -> list:
    """(name, JAX package line it twins, plain version, shape, native call,
    plain call, whether the two outputs are equal) of every entry point of
    the native host tier, at N 1024 and 2048 (the keystream at block
    counters 0, 12345 and 2^33, timed at 2^20 blocks)."""
    import numpy as np
    import torch

    from poulpy_tpu_torch import native
    from poulpy_tpu_torch.hal import normalization, ntt, source, znx
    from poulpy_tpu_torch.hal.module import get_module

    extremes = np.array([0, 1, -1, 2**62, -(2**62), 2**63 - 1, -(2**63), 2**40 - 1, -(2**40)],
                        dtype=np.int64)

    def ints(seed: int, shape: tuple):
        x = np.random.default_rng(seed).integers(-(2**63), 2**63 - 1, shape, dtype=np.int64,
                                                 endpoint=True)
        x.reshape(-1, shape[-1])[0, : extremes.size] = extremes
        return x

    def same(x, y) -> bool:
        y = y.numpy() if isinstance(y, torch.Tensor) else y
        return x.shape == y.shape and bool(np.array_equal(x, y))

    jx = "poulpy_tpu/native/kernels.cpp"
    key = np.random.default_rng(7).integers(0, 2**32, 8, dtype=np.uint32)
    cases = [("chacha8_blocks", f"{jx}:42", "hal/source.py _chacha_blocks", [c0, 4096, 16],
              lambda c0=c0: native.chacha8_blocks(key, c0, 4096),
              lambda c0=c0: source._chacha_blocks(key, c0, 4096), same)
             for c0 in (0, 12345, 2**33)]
    cases.append(("chacha8_blocks", f"{jx}:42", "hal/source.py plain_keystream",
                  [0, 1 << 20, 16], lambda: native.chacha8_blocks(key, 0, 1 << 20),
                  lambda: source.plain_keystream(key, 0, 1 << 20), same))
    for n in (1024, 2048):
        a = ints(n, (64, n))
        ta = torch.from_numpy(a)
        for p in (5, n - 1, -(n + 3)):
            cases.append(("znx_rotate", f"{jx}:70", "hal/znx.py znx_rotate", [64, n, p],
                          lambda a=a, p=p: native.znx_rotate(p, a),
                          lambda ta=ta, p=p: znx.znx_rotate(p, ta), same))
        for p in (3, 2 * n - 1):
            cases.append(("znx_automorphism", f"{jx}:85", "hal/znx.py znx_automorphism",
                          [64, n, p], lambda a=a, p=p: native.znx_automorphism(p, a),
                          lambda ta=ta, p=p: znx.znx_automorphism(p, ta), same))
        v = ints(n + 1, (16, 4, n))
        tv = torch.from_numpy(v)
        for lsh in (0, 3):
            cases.append(("vec_znx_normalize", f"{jx}:117",
                          "hal/normalization.py vec_znx_normalize", [16, 4, n, 17, lsh],
                          lambda v=v, lsh=lsh: native.vec_znx_normalize(17, v, lsh),
                          lambda tv=tv, lsh=lsh: normalization.vec_znx_normalize(17, tv, lsh),
                          same))
        t = get_module(n, 2, 28, "cpu").tables
        psi, psi_inv, n_inv = ntt._host_tables(t.basis.primes, n)
        rng = np.random.default_rng(n + 2)
        x = np.stack([rng.integers(0, p, (16, n)) for p in t.basis.primes], axis=1)
        tx = torch.from_numpy(x)
        fwd = ntt.ntt_forward(t, tx)
        prime = [(int(p), int(t.basis.qinv_arr[i])) for i, p in enumerate(t.basis.primes)]
        cases.append(("ntt_forward", f"{jx}:204", "hal/ntt.py ntt_forward", [16, 2, n],
                      lambda x=x, psi=psi, prime=prime: np.stack(
                          [native.ntt_forward(psi[i], p, q, x[:, i])
                           for i, (p, q) in enumerate(prime)], axis=1),
                      lambda t=t, tx=tx: ntt.ntt_forward(t, tx), same))
        xf = fwd.numpy()
        cases.append(("ntt_inverse", f"{jx}:230", "hal/ntt.py ntt_inverse", [16, 2, n],
                      lambda xf=xf, psi_inv=psi_inv, n_inv=n_inv, prime=prime: np.stack(
                          [native.ntt_inverse(psi_inv[i], int(n_inv[i]), p, q, xf[:, i])
                           for i, (p, q) in enumerate(prime)], axis=1),
                      lambda t=t, fwd=fwd: ntt.ntt_inverse(t, fwd), same))
        a1 = ints(n + 3, (1, n))
        b1 = np.random.default_rng(n + 4).integers(-(2**40), 2**40, (1, n), dtype=np.int64)
        cases.append(("negacyclic_conv_i128", f"{jx}:177", "Python big-int product", [1, n],
                      lambda a1=a1, b1=b1: [[(int(h) << 64) | int(lo) for h, lo in zip(
                          *(r[0] for r in native.negacyclic_conv_i128(a1, b1)))]],
                      lambda a1=a1, b1=b1: [bigint_product(a1[0], b1[0])],
                      lambda x, y: x == y))
        a2 = np.random.default_rng(n + 5).integers(-(2**40), 2**40, n, dtype=np.int64)
        cases.append(("negacyclic_mul_exact", f"{jx}:155", "Python big-int product", [n],
                      lambda a2=a2, b1=b1: native.negacyclic_mul_exact(a2, b1[0]),
                      lambda a2=a2, b1=b1: bigint_product(a2, b1[0]), lambda x, y: x == y))
    return cases


def phase_native() -> None:
    """The native host tier: its g++ build on this host (the compiler's
    version, the seconds, the host CPU), then each entry point against its
    plain version on the same inputs, tolerance 0, both timed on the host
    clock; one line {"native": [...]}.  Exits non-zero on any difference."""
    import os

    from poulpy_tpu_torch import native

    t0 = time.perf_counter()
    native.library()
    seconds = time.perf_counter() - t0
    version = subprocess.run([native.CXX, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    cpu = native.host_cpu()
    emit(phase="native_build", compiler=version, flags=list(native.FLAGS), seconds=seconds,
         built=native.build_info["built"], cpu=cpu["model"], machine=cpu["machine"],
         cpus=os.cpu_count(), library=str(Path(native.build_info["path"]).relative_to(ROOT)))
    rows, failed = [], []
    for name, replaces, plain, shape, run, run_plain, equal in native_cases():
        ok = equal(run(), run_plain())
        rows.append(dict(name=name, route="cpp", source="poulpy_tpu_torch/native/kernels.cpp",
                         replaces=replaces, plain=plain, shape=shape, equal=ok,
                         max_abs_err=0 if ok else None, ms=host_ms(run, 3),
                         plain_ms=host_ms(run_plain, 3), cpu=cpu["model"]))
        if not ok:
            failed.append((name, shape))
    print(json.dumps({"native": rows}), flush=True)
    if failed:
        raise SystemExit(f"native entry points differ from their plain versions: {failed}")


def phase_ntt_shapes(tally: Counter) -> None:
    """The NTT kernel at each shape the paths launched it (`tally`: launches
    per (direction, P, N, rows per prime, prime bits), summed over the
    paths), on residues of its own on that basis (get_module(N, P, bits)):
    both designs equal to the plain version, tolerance 0, each one's time
    (CUDA events, 5 launches through the wrapper, its host time included
    where it exceeds the kernel's), launches × (ms − bound), the loss that
    rule 2 of ROADMAP scores, and its device time (`graph_ms`, 20 launches
    in a CUDA graph); then the sums per direction and design of both losses
    (the device one with device_ms in place of ms)."""
    import torch

    from poulpy_tpu_torch.backends import ntt
    from poulpy_tpu_torch.hal.module import get_module

    gen = torch.Generator(device="cuda").manual_seed(11)
    total, device_total = Counter(), Counter()
    for (direction, P, n, rows, bits), launches in sorted(tally.items()):
        t = get_module(n, P, bits, "cuda").tables
        primes = torch.tensor(t.basis.primes, device="cuda")[:, None]
        x = (torch.randint(0, 1 << 62, (rows, P, n), generator=gen, device="cuda") % primes).to(
            torch.int32)
        fn = getattr(ntt, direction)
        want = getattr(ntt, direction + "_ref")(t, x)
        bnd = bound(2 * x.numel() * 4, ntt_ops(rows * P, n, direction == "ntt_inverse"))
        designs = {}
        for design in ntt.DESIGNS:
            if not torch.equal(fn(t, x, design=design), want):
                raise SystemExit(f"ntt_shape: the {design} {direction} at [{rows}, {P}, {n}] "
                                 f"({bits}-bit primes) disagrees with its plain version")
            ms = cuda_ms(lambda design=design: fn(t, x, design=design), 5)
            loss = launches * (ms - bnd["bound_ms"])
            total[f"{direction}/{design}"] += loss
            device_ms = graph_ms(lambda design=design: fn(t, x, design=design), 20)
            device_total[f"{direction}/{design}"] += launches * (device_ms - bnd["bound_ms"])
            designs[design] = dict(ms=ms, loss_ms=loss, device_ms=device_ms)
        emit(phase="ntt_shape", kernel=direction, nprimes=P, n=n, rows=rows, prime_bits=bits,
             launches=launches, equal=True, tolerance=0, bound_ms=bnd["bound_ms"], **designs)
        del x, want
    emit(phase="ntt_shapes", path="all", loss_ms=dict(total), device_loss_ms=dict(device_total))


def phase_kernels_large_n() -> None:
    """Each product kernel at a shape whose rows do not fit in shared memory
    (bench.py's product at N 8192; the CKKS key's keyswitch, the gate's
    block step and the CKKS-wide pair at N 4096), batch 2–4, against its
    plain version, tolerance 0, with the layout its launch takes (the
    wrappers' own formula) and its time."""
    import torch

    from poulpy_tpu_torch.backends import fused, fused_mxu, mxu, wide
    from poulpy_tpu_torch.hal.module import get_module

    gen = torch.Generator(device="cuda").manual_seed(8)

    def ints(lim, shape):
        return torch.randint(-lim, lim, shape, generator=gen, device="cuda", dtype=torch.int64)

    def residues(mod, shape):
        primes = torch.tensor(mod.basis.primes, device="cuda")[:, None]
        return (ints(1 << 62, shape).abs() % primes).to(torch.int32)

    m8, m4, w4 = (get_module(8192, 2, 28, "cuda"), get_module(4096, 2, 28, "cuda"),
                  get_module(4096, 5, 28, "cuda"))
    a8, pmat8 = ints(2**16, (2, 2, 3, 8192)), residues(m8, (3, 2, 2, 4, 2, 8192))
    ks_a, ks_key, ks_body = (ints(2**16, (4, 1, 6, 4096)), residues(m4, (6, 1, 2, 6, 2, 4096)),
                             ints(2**16, (4, 6, 4096)))
    acc, brk = ints(2**16, (4, 2, 2, 4096)), residues(m4, (GATE_BLOCK, 4, 2, 2, 4, 2, 4096))
    amounts = ints(3 * 4096, (4, GATE_BLOCK))
    pm_k = fused.pm_kernel_layout(brk[..., mxu.sigma_index(m4.tables)], 2)
    wd, wkey, wlin = (ints(2**51, (2, 1, 2, 4096)), residues(w4, (2, 1, 2, 3, 5, 4096)),
                      ints(2**51, (2, 2, 3, 4096)))
    wa, wb = ints(2**51, (2, 2, 2, 4096)), ints(2**51, (2, 2, 2, 4096))
    ta, tb = ints(2**16, (3, 2, 6, 4096)), ints(2**16, (3, 2, 6, 4096))
    sacc, spmat, samt = (ints(2**40, (2, 2, 2, 8192)), residues(m8, (3, 2, 2, 4, 2, 8192)),
                         ints(2 * 8192, (2,)))

    def flat(fn, *args):
        return lambda: torch.cat([x.flatten() for x in fn(*args)])

    cases = {
        "fused_product": (fused.butterfly_layout(6, 2, 4, 2, 8192, 3),
                          lambda: fused.fused_glwe_product(m8, a8, pmat8, 3, BASE2K, BASE2K),
                          lambda: fused.fused_glwe_product_ref(m8, a8, pmat8, 3, BASE2K, BASE2K)),
        "fused_product_small": (
            fused.butterfly_layout(6, 2, 6, 2, 4096, 6),
            lambda: fused.fused_glwe_product(m4, ks_a, ks_key, 6, BASE2K, BASE2K, small=ks_body),
            lambda: fused.fused_glwe_product_ref(m4, ks_a, ks_key, 6, BASE2K, BASE2K,
                                                 small=ks_body)),
        "fused_product_small64": (
            fused.butterfly_layout(6, 2, 6, 2, 4096, 12),
            lambda: fused.fused_glwe_product(m4, ks_a, ks_key, 12, BASE2K, BASE2K,
                                             small64=ks_body[:, None].expand(4, 2, 6, 4096)),
            lambda: fused.fused_glwe_product_ref(m4, ks_a, ks_key, 12, BASE2K, BASE2K,
                                                 small64=ks_body[:, None].expand(4, 2, 6, 4096))),
        "fused_br_step": (fused.butterfly_layout(4, 2, 4, 2, 8192, 2, step=True),
                          lambda: fused.fused_br_step(m8, sacc, spmat, samt, 2, BASE2K),
                          lambda: fused.fused_br_step_ref(m8, sacc, spmat, samt, 2, BASE2K)),
        "br_block_step": (fused.butterfly_layout(4, 2, 4, 2, 4096, 2, GATE_BLOCK, split=False),
                          lambda: fused.fused_br_block_step(m4, acc, brk, amounts, 2, BASE2K),
                          lambda: fused.fused_br_block_step_ref(m4, acc, brk, amounts, 2, BASE2K)),
        "wide_product": (wide.wide_design_layout(2, 2, 3, 5, 4096),
                         lambda: wide.fused_glwe_product_wide(w4, wd, wkey, 2, 52, 52, small=wlin),
                         lambda: wide.fused_glwe_product_wide_ref(w4, wd, wkey, 2, 52, 52,
                                                                  small=wlin)),
        "tensor_product": (fused.tensor_design_layout(6, 6, 11, 2, 4096),
                           flat(fused.fused_tensor_product, m4, ta, tb, 11, 6, BASE2K, BASE2K),
                           flat(fused.fused_tensor_product_ref, m4, ta, tb, 11, 6, BASE2K,
                                BASE2K)),
        "wide_tensor": (fused.tensor_design_layout(2, 2, 3, 5, 4096, parent=wide.tensor_wide_layout),
                        flat(wide.fused_tensor_product_wide, w4, wa, wb, 3, 2, 3, 52, 52,
                             WIDE_OFFSET),
                        flat(wide.fused_tensor_product_wide_ref, w4, wa, wb, 3, 2, 3, 52, 52,
                             WIDE_OFFSET)),
        "fused_mxu_product": (
            fused_mxu.mxu_layout(6, 2, 4, 2, 8192),
            lambda: fused_mxu.fused_mxu_glwe_product(m8, a8, pmat8, 3, BASE2K, BASE2K),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(m8, a8, pmat8, 3, BASE2K, BASE2K)),
        "fused_mxu_product_small": (
            fused_mxu.mxu_layout(6, 2, 6, 2, 4096),
            lambda: fused_mxu.fused_mxu_glwe_product(m4, ks_a, ks_key, 6, BASE2K, BASE2K,
                                                     small=ks_body),
            lambda: fused_mxu.fused_mxu_glwe_product_ref(m4, ks_a, ks_key, 6, BASE2K, BASE2K,
                                                         small=ks_body)),
        "fused_mxu_br_block_step": (
            fused_mxu.mxu_layout(4, 2, 4, 2, 4096, split=False),
            lambda: fused_mxu.fused_mxu_br_block_step(m4, acc, brk, amounts, 2, BASE2K, pm_k),
            lambda: fused_mxu.fused_mxu_br_block_step_ref(m4, acc, brk, amounts, 2, BASE2K)),
    }
    for name, (lay, kernel, plain) in cases.items():
        have, want = kernel(), plain()
        torch.cuda.synchronize()
        equal = bool(torch.equal(have, want))
        emit(phase="kernels_large_n", kernel=name, shape=list(have.shape), layout=lay.kind,
             smem=lay.smem, rows_per_pass=lay.chunk, cols_per_block=lay.cpb, equal=equal,
             tolerance=0, max_abs_err=int((have - want).abs().max()), ms=cuda_ms(kernel, 3))
        if not equal or lay.kind != "global":
            raise SystemExit(f"large-N {name}: layout {lay.kind}, equal {equal}")


def decrypts_to_x_m(m, skp, data, out) -> bool:
    """The product by the GGSW of X decrypts to X·m exactly."""
    import torch

    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.layouts import GLWECiphertext
    from poulpy_tpu_torch.hal import vec_znx, znx

    ptd = glwe_decrypt(m, GLWECiphertext(data=out, base2k=BASE2K, k=K_CT), skp)
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, ptd.data)
    return bool(torch.equal(got, znx.znx_rotate(1, data)))


def phase_verify(m) -> tuple:
    """bench.py verify_on_device: stage by stage equals fused; decrypt exact.
    Returns the set-up (secret, data, ciphertexts, GGSW) for the MXU gates."""
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product
    from poulpy_tpu_torch.hal import dft

    skp, data, ct, ggswp = keys_and_ciphertexts(m, VERIFY_BATCH, seed=7)
    res_size = ct.data.shape[-2]
    a_dft = dft.dft_apply(m, ct.data)
    big = dft.idft_apply(m, dft.vmp_apply(m, a_dft, ggswp.pmat))
    want = dft.big_normalize(m, res_size, BASE2K, big, BASE2K)
    have = fused_glwe_product(m, ct.data, ggswp.pmat, res_size, BASE2K, BASE2K)
    exact = bool(torch.equal(have, want))
    dec_ok = decrypts_to_x_m(m, skp, data, have)
    emit(phase="verify", fused_vs_stages_bit_exact=exact, decrypt_exact=dec_ok,
         batch=VERIFY_BATCH)
    if not (exact and dec_ok):
        raise SystemExit("verify failed")
    return skp, data, ct, ggswp


def phase_route_verify(m, setup, route: str) -> None:
    """bench.py's MXU A/B gate at VERIFY_BATCH: the route's product equals the
    butterfly fused kernel's bit for bit and decrypts to X·m."""
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product
    from poulpy_tpu_torch.core.external_product import glwe_external_product

    skp, data, ct, ggswp = setup
    want = fused_glwe_product(m, ct.data, ggswp.pmat, ct.data.shape[-2], BASE2K, BASE2K)
    have = glwe_external_product(m, ct, ggswp, route=route).data
    exact = bool(torch.equal(have, want))
    dec_ok = decrypts_to_x_m(m, skp, data, have)
    emit(phase=f"verify_{route}", route=route, route_vs_fused_bit_exact=exact,
         decrypt_exact=dec_ok, batch=VERIFY_BATCH)
    if not (exact and dec_ok):
        raise SystemExit(f"the {route} route's A/B gate failed")


def chain_bench(m, ct, ggswp, route: str, phase: str, profile: bool) -> None:
    """1 warm-up + ITERS timed chained products through `route`, ending in
    the checksum; with `profile`, one more product under torch.profiler."""
    import torch

    from poulpy_tpu_torch.core.external_product import glwe_external_product

    def checksum(c):
        return int((c.data.abs() % 65536).sum())

    out = glwe_external_product(m, ct, ggswp, route=route)
    checksum(out)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(ITERS):
        out = glwe_external_product(m, out, ggswp, route=route)
    value = checksum(out)
    dt = time.perf_counter() - t0
    emit(phase=phase, route=route, batch=BATCH, iters=ITERS, products_per_s=BATCH * ITERS / dt,
         ms_per_iter=dt / ITERS * 1e3, checksum=value, checksum_expected=CHECKSUM,
         shape=list(out.data.shape), peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30)
    if value != CHECKSUM:
        raise SystemExit(f"{phase}: checksum {value} != {CHECKSUM}")
    if profile:
        profile_once(f"{phase}_profile", lambda: glwe_external_product(m, out, ggswp, route=route),
                     dt / ITERS * 1e3)


def phase_bench(m) -> tuple:
    """bench.py main(): 1 warm-up + 30 timed chained products at B = 16384.
    Returns the batch and the GGSW for the MXU routes' runs."""
    import torch

    t0 = time.perf_counter()
    ct, ggswp = keys_and_ciphertexts(m, BATCH, seed=0)[2:]   # the 256 MiB of messages go
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    emit(phase="setup", batch=BATCH, keygen_encrypt_prepare_s=setup_s,
         allocated_gib=torch.cuda.memory_allocated() / 2**30)
    chain_bench(m, ct, ggswp, "fused", "bench", profile=False)
    return ct, ggswp


def gate_setup(params, batch: int, device):
    """bench_full.py bench_gate_bootstrap's set-up: keygen from bytes(32), the
    bits from default_rng(0) and (1), encrypted from Source 0x05 / 0x06."""
    import numpy as np

    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.hal.source import Source

    keys, sk = gates.keygen(params, bytes(32), device=device)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    b1 = np.random.default_rng(0).integers(0, 2, batch)
    b2 = np.random.default_rng(1).integers(0, 2, batch)
    c1 = gates.encrypt_bit(params, b1, sk, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk, xe, xa)
    return keys, sk, b1, b2, c1, c2


def plain_block_rotation(keys, lwe, step_ref):
    """The block path with the plain step `step_ref` (fused_br_block_step_ref
    or fused_mxu_br_block_step_ref) in place of the kernel (the same mod
    switch, accumulator and blocks as blind_rotation_execute_block)."""
    from poulpy_tpu_torch.binfhe.blind_rotation import _acc_init, mod_switch_2n

    m, brk, lut, block = keys.module, keys.brk, keys.lut, keys.params.block_size
    lwe_2n = mod_switch_2n(2 * m.n, lwe, lut.rot_dir)
    acc = _acc_init(lwe_2n[..., 0], lut, brk.rank)
    for j in range(brk.n_lwe // block):
        blk = slice(j * block, (j + 1) * block)
        acc = step_ref(m, acc, brk.pmats[blk], lwe_2n[..., 1:][..., blk], lut.size, brk.base2k)
    return acc


def phase_gate_verify(setup, std_params, batch: int, route: str = "fused") -> None:
    """Block path through `route` == its plain block path (and, for an MXU
    route, == the butterfly route); NAND truth on both BR paths, the
    standard path through the route == the butterfly's."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends.fused import fused_br_block_step_ref
    from poulpy_tpu_torch.backends.fused_mxu import fused_mxu_br_block_step_ref
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.binfhe.blind_rotation import (
        blind_rotation_execute,
        blind_rotation_execute_block,
    )
    from poulpy_tpu_torch.core.layouts import LWECiphertext
    from poulpy_tpu_torch.hal.normalization import vec_znx_normalize

    def linear(p, c1, c2):
        return LWECiphertext(data=vec_znx_normalize(p.base2k, gates._const_lwe(p, 1, 3, c1)
                                                    - c1.data - c2.data), base2k=p.base2k,
                             k=p.k_ct)

    keys, sk, b1, b2, c1, c2 = setup
    p = keys.params
    c1, c2, b1, b2 = (c1.replace(data=c1.data[:batch]), c2.replace(data=c2.data[:batch]),
                      b1[:batch], b2[:batch])
    lin = linear(p, c1, c2)
    have = blind_rotation_execute_block(keys.module, lin, keys.lut, keys.brk, p.block_size, route)
    step_ref = fused_mxu_br_block_step_ref if route == "fused_mxu" else fused_br_block_step_ref
    checks = {"block_kernel_vs_plain_bit_exact": bool(torch.equal(
        have, plain_block_rotation(keys, lin, step_ref)))}
    if route != "fused":
        checks["block_route_vs_butterfly_bit_exact"] = bool(torch.equal(
            have, blind_rotation_execute_block(keys.module, lin, keys.lut, keys.brk,
                                               p.block_size)))
    checks["block_nand_truth"] = bool(np.array_equal(
        gates.decrypt_bit(gates.gate_nand(keys, c1, c2, route=route), sk), 1 - (b1 & b2)))
    skeys, ssk, sb1, sb2, sc1, sc2 = gate_setup(std_params, batch, keys.module.device)
    if route != "fused":
        slin = linear(std_params, sc1, sc2)
        checks["standard_route_vs_butterfly_bit_exact"] = bool(torch.equal(
            blind_rotation_execute(skeys.module, slin, skeys.lut, skeys.brk, route),
            blind_rotation_execute(skeys.module, slin, skeys.lut, skeys.brk)))
    checks["standard_nand_truth"] = bool(np.array_equal(
        gates.decrypt_bit(gates.gate_nand(skeys, sc1, sc2, route=route), ssk), 1 - (sb1 & sb2)))
    emit(phase="gate_verify" if route == "fused" else f"gate_verify_{route}", batch=batch,
         standard_n_lwe=std_params.n_lwe, **checks)
    if not all(checks.values()):
        raise SystemExit(f"gate verify through the {route} route failed")


def phase_gate_bench(setup, iters: int, fingerprint: int | None, route: str = "fused",
                     butterfly_gates_per_s: float | None = None) -> tuple[float, dict]:
    """1 warm-up NAND (fingerprint, truth) + `iters` timed chained NANDs
    through `route`; returns the gates/s and the launches per NAND."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.binfhe import gates

    keys, sk, b1, b2, c1, c2 = setup
    device = keys.module.device
    batch = len(b1)
    name = "gate" if route == "fused" else f"gate_{route}"

    def checksum(ct):
        return int((ct.data.abs() % 65536).sum())

    out = gates.gate_nand(keys, c1, c2, route=route)
    value = checksum(out)
    truth = bool(np.array_equal(gates.decrypt_bit(out, sk), 1 - (b1 & b2)))
    emit(phase=f"{name}_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         nand_truth=truth, shape=list(out.data.shape))
    if not truth or (fingerprint is not None and value != fingerprint):
        raise SystemExit(f"{name} warm-up failed: fingerprint {value}, truth {truth}")
    expect = 1 - (b1 & b2)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = gates.gate_nand(keys, out, c2, route=route)
        expect = 1 - (expect & b2)
    value = checksum(out)
    dt = time.perf_counter() - t0
    per_nand = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    truth = bool(np.array_equal(gates.decrypt_bit(out, sk), expect))
    extra = {} if butterfly_gates_per_s is None else {
        "butterfly_gates_per_s": butterfly_gates_per_s}
    block_steps = {k: per_nand.get(k, 0) for k in BLOCK_STEP_KERNELS}
    want = block_launches(keys.params.n_lwe, keys.params.block_size, route)
    emit(phase=f"{name}_bench", route=route, batch=batch, iters=iters,
         gates_per_s=batch * iters / dt, **extra, ms_per_batch=dt / iters * 1e3, checksum=value,
         decrypt_matches_tracked_bits=truth, launches_per_nand=per_nand,
         block_steps_per_nand=block_steps, block_steps_expected=want,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None)
    if not truth:
        raise SystemExit("chained NANDs decrypt to the wrong bits")
    if device.type == "cuda" and block_steps != want:
        raise SystemExit(f"{name}: block-step launches per NAND {block_steps}, not {want}")
    if device.type == "cuda":
        profile_once(f"{name}_profile", lambda: gates.gate_nand(keys, out, c2, route=route),
                     dt / iters * 1e3)
    return batch * iters / dt, per_nand


def profile_once(phase: str, fn, timed_ms: float) -> dict:
    """Two more calls of `fn` under torch.profiler, the first a warm-up step
    that takes the profiler's own start-up: the second's wall time, device
    busy time (the sum of kernel and copy times, CUDA activity) and the
    kernels that take it.  The profiler's host-side tracing lengthens the
    wall time of a call made of many small launches, so the busy time is
    also given as a share of `timed_ms`, the same call's time in the
    unprofiled timed loop.  The trace now and then lacks some of the step's
    kernels; it is taken again (3 tries at most) until it holds one event
    per csrc/ kernel launched in the step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    from poulpy_tpu_torch.backends import LAUNCHES

    for attempt in range(1, 4):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            for _ in range(2):
                launched = sum(LAUNCHES.values())
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                launched = sum(LAUNCHES.values()) - launched
                prof.step()
        device = {}                               # kernel or copy name → [ms, count]
        for e in prof.events():
            # the schedule's ProfilerStep range spans the step: not device work
            if (e.device_type == torch.autograd.DeviceType.CUDA
                    and not e.name.startswith("ProfilerStep")):
                entry = device.setdefault(e.name, [0.0, 0])
                entry[0] += e.time_range.elapsed_us() / 1e3
                entry[1] += 1
        # the kernels of csrc/ (each in an anonymous namespace, or in namespace poulpy
        # for tensor.cuh's) against torch's own (a template kernel's name starts with
        # its return type: "void (anonymous namespace)::…", "void poulpy::…")
        csrc = [v for k, v in device.items()
                if k.startswith(("(anonymous namespace)::", "void (anonymous namespace)::",
                                 "void poulpy::"))]
        if sum(c for _, c in csrc) >= launched:
            break
    busy_ms = sum(ms for ms, _ in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][0])[:6]
    row = dict(phase=phase, wall_ms=wall_ms, device_busy_ms=busy_ms, busy_share=busy_ms / wall_ms,
               timed_ms=timed_ms, busy_share_of_timed=busy_ms / timed_ms,
               csrc_kernels_ms=sum(ms for ms, _ in csrc), csrc_launches=launched,
               csrc_events=sum(c for _, c in csrc), tries=attempt,
               device_events=sum(c for _, c in device.values()),
               top=[dict(name=k[:90], device_ms=ms, count=c) for k, (ms, c) in top])
    emit(**row)
    return row


def ks_chain(m, c, ksk, count: int, route: str = "fused") -> int:
    """`count` chained keyswitches through `route`, then a host-materialized
    checksum."""
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch

    for _ in range(count):
        c = glwe_keyswitch(m, c, ksk, route=route)
    return int((c.data.abs() % 65536).sum())


def phase_keyswitch(device, n: int) -> tuple:
    """bench_full.py's keyswitch at its configuration: the kernel against the
    plain keyswitch at batch 8 (and an exact decrypt), chained single
    keyswitches, chained batched keyswitches.  Returns the set-up for the MXU
    routes' runs."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends.fused import fused_glwe_product_ref
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.core.layouts import GLWEPlaintext
    from poulpy_tpu_torch.core.prepared import gglwe_prepare, glwe_secret_prepare
    from poulpy_tpu_torch.hal import vec_znx
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source

    m = get_module(n, 2, device=device)
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk1, sk2 = enc.secret_new(m, 1, src), enc.secret_new(m, 1, src)
    sk1p, sk2p = glwe_secret_prepare(m, sk1), glwe_secret_prepare(m, sk2)
    ksk = gglwe_prepare(m, enc.glwe_switching_key_encrypt_sk(
        m, sk1, sk2p, BASE2K, KS_K_KEY, dnum=KS_DNUM, source_xe=xe, source_xa=xa))

    def encrypt(data):
        pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BASE2K, K_PT, 3, torch.from_numpy(data)
                                                       .to(m.device)), base2k=BASE2K, k=K_PT)
        return enc.glwe_encrypt_sk(m, pt, sk1p, BASE2K, K_CT, xe, xa,
                                   batch_shape=data.shape[:-1])

    data = np.random.default_rng(2).integers(-(2**15), 2**15, (KS_VERIFY_BATCH, n))
    ct = encrypt(data)
    have = glwe_keyswitch(m, ct, ksk)
    want = fused_glwe_product_ref(m, ct.data[..., 1:, :, :], ksk.pmat, 3, BASE2K, BASE2K,
                                  small=ct.data[..., 0, :, :])
    exact = bool(torch.equal(have.data, want))
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, glwe_decrypt(m, have, sk2p).data)
    dec_ok = bool(torch.equal(got.cpu(), torch.from_numpy(data)))

    def chain(c, count):
        return ks_chain(m, c, ksk, count)

    single = encrypt(np.random.default_rng(0).integers(-(2**15), 2**15, n))
    chain(single, 1)
    lat = []
    for _ in range(KS_REPS):
        t0 = time.perf_counter()
        chain(single, KS_CHAIN)
        lat.append((time.perf_counter() - t0) / KS_CHAIN * 1e3)
    batched = single.replace(data=single.data.expand((KS_BATCH,) + single.data.shape)
                             .contiguous())
    chain(batched, 1)
    t0 = time.perf_counter()
    chain(batched, KS_ITERS)
    dt = time.perf_counter() - t0
    emit(phase="keyswitch", n=n, kernel_vs_plain_bit_exact=exact, decrypt_exact=dec_ok,
         verify_batch=KS_VERIFY_BATCH, chain=KS_CHAIN, single_ms_median=float(np.median(lat)),
         single_ms=lat, batch=KS_BATCH, iters=KS_ITERS, cts_per_s=KS_BATCH * KS_ITERS / dt)
    if not (exact and dec_ok):
        raise SystemExit("keyswitch verify failed")
    return m, ksk, sk2p, data, ct, batched


def phase_keyswitch_route(setup, route: str) -> None:
    """The keyswitch path through `route`: equal to the butterfly route at
    batch KS_VERIFY_BATCH (and an exact decrypt), then 1 + KS_ITERS chained
    keyswitches at batch KS_BATCH."""
    import torch

    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.keyswitching import glwe_keyswitch
    from poulpy_tpu_torch.hal import vec_znx

    m, ksk, sk2p, data, ct, batched = setup
    have = glwe_keyswitch(m, ct, ksk, route=route)
    exact = bool(torch.equal(have.data, glwe_keyswitch(m, ct, ksk).data))
    got = vec_znx.decode_vec_i64(BASE2K, K_PT, glwe_decrypt(m, have, sk2p).data)
    dec_ok = bool(torch.equal(got.cpu(), torch.from_numpy(data)))
    ks_chain(m, batched, ksk, 1, route)
    t0 = time.perf_counter()
    value = ks_chain(m, batched, ksk, KS_ITERS, route)
    dt = time.perf_counter() - t0
    want = ks_chain(m, batched, ksk, KS_ITERS)
    emit(phase=f"keyswitch_{route}", route=route, route_vs_fused_bit_exact=exact,
         decrypt_exact=dec_ok, verify_batch=KS_VERIFY_BATCH, batch=KS_BATCH, iters=KS_ITERS,
         cts_per_s=KS_BATCH * KS_ITERS / dt, checksum=value, checksum_fused=want)
    if not (exact and dec_ok and value == want):
        raise SystemExit(f"keyswitch through the {route} route failed")


def ckks_setup(cfg: CkksConfig, batch: int, iters: int, device):
    """bench_full.py's CKKS set-up: the secret from bytes(32), the tensor key
    from Source 0x01 / 0x02, the slots z from default_rng(seed), its pair
    (c1, c2) of encryptions of z; then `iters` distinct pairs of batches of
    `batch` encryptions of z, drawn on from the same sources."""
    import numpy as np

    from poulpy_tpu_torch.ckks import ops as ck
    from poulpy_tpu_torch.ckks.encoder import Encoder
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import glwe_secret_prepare, glwe_tensor_key_prepare
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source

    m = get_module(cfg.n, cfg.nprimes, 28, device)
    dist = {"dist": "ternary_hw", "hw": cfg.hw} if cfg.hw else {}
    sk = enc.secret_new(m, 1, Source(bytes(32)), **dist)
    skp = glwe_secret_prepare(m, sk)
    xe, xa = Source(b"\x01" * 32), Source(b"\x02" * 32)
    tsk = glwe_tensor_key_prepare(m, enc.glwe_tensor_key_encrypt_sk(
        m, sk, skp, cfg.base2k, cfg.k_key, dnum=cfg.dnum, source_xe=xe, source_xa=xa))
    encoder = Encoder(cfg.n)
    rng = np.random.default_rng(cfg.seed)
    z = rng.normal(size=cfg.n // 2) + 1j * rng.normal(size=cfg.n // 2)
    pt = ck.encode(encoder, z, cfg.base2k, cfg.k_ct, cfg.log_delta, cfg.log_budget,
                   device=m.device)
    pair = [ck.encrypt_sk(m, pt, skp, cfg.k_ct, xe, xa) for _ in range(2)]
    timed = [ck.encrypt_sk(m, pt, skp, cfg.k_ct, xe, xa, batch_shape=(iters, batch))
             for _ in range(2)]
    return m, skp, tsk, encoder, z, pair, timed


def ckks_mul(m, a, b, tsk, cfg: CkksConfig):
    """bench_full.py's timed step: mul, then rescale(cfg.rescale) if set."""
    from poulpy_tpu_torch.ckks import ops as ck

    out = ck.mul(m, a, b, tsk)
    return ck.rescale(out, cfg.rescale) if cfg.rescale else out


def run_ckks_path(name: str, cfg: CkksConfig, device, batch: int, iters: int,
                  fingerprint: int | None) -> tuple:
    """Set-up, 1 warm-up mul of bench_full.py's pair broadcast to `batch`
    rows (fingerprint of row 0, every row equal, decode error), `iters`
    timed muls on distinct batches ending in a host checksum, and one
    profiled mul.  Returns the set-up (`ckks_setup`'s tuple) for the paths
    that share it."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.ckks import ops as ck

    t0 = time.perf_counter()
    m, skp, tsk, encoder, z, (c1, c2), (t1, t2) = ckks_setup(cfg, batch, iters, device)
    sync(device)
    setup_s = time.perf_counter() - t0
    key = tsk.keys[(0, 0)]
    emit(phase=f"{name}_setup", batch=batch, iters=iters, setup_s=setup_s,
         tensor_key_mib=key.pmat.numel() * key.pmat.element_size() / 2**20)

    def rows(c, data):
        return c.replace(glwe=c.glwe.replace(data=data))

    def err(ct):
        got = ck.decode(encoder, ck.decrypt(m, rows(ct, ct.glwe.data[0]), skp))
        return float(np.abs(got - z * z).max())

    shape = (batch,) + tuple(c1.glwe.data.shape)
    out = ckks_mul(m, rows(c1, c1.glwe.data.expand(shape).contiguous()),
                   rows(c2, c2.glwe.data.expand(shape).contiguous()), tsk, cfg)
    data = out.glwe.data
    value = int((data[0].abs() % 65536).sum())
    rows_equal = bool((data == data[:1]).all())
    warm_err = err(out)
    emit(phase=f"{name}_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         rows_equal=rows_equal, decode_err_vs_z2=warm_err, shape=list(data.shape),
         log_delta=out.meta.log_delta, log_budget=out.meta.log_budget)
    if not rows_equal or (fingerprint is not None and value != fingerprint):
        raise SystemExit(f"{name} warm-up failed: fingerprint {value}, rows equal {rows_equal}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        out = ckks_mul(m, rows(t1, t1.glwe.data[i]), rows(t2, t2.glwe.data[i]), tsk, cfg)
    value = int((out.glwe.data.abs() % 65536).sum())
    dt = time.perf_counter() - t0
    per_mul = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    timed_err = err(out)
    emit(phase=name, batch=batch, iters=iters, muls_per_s=batch * iters / dt,
         ms_per_batch=dt / iters * 1e3, checksum=value, decode_err_vs_z2=timed_err,
         launches_per_mul=per_mul,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None)
    if not timed_err <= 4 * warm_err:    # fresh noise, the same parameters: the same scale
        raise SystemExit(f"{name}: the timed product decodes {timed_err} away from z·z, "
                         f"the warm-up {warm_err}")
    if device.type == "cuda":
        profile_once(f"{name}_profile",
                     lambda: ckks_mul(m, rows(t1, t1.glwe.data[0]), rows(t2, t2.glwe.data[0]),
                                      tsk, cfg), dt / iters * 1e3)
    return m, skp, tsk, encoder, z, (c1, c2), (t1, t2)


def broadcast(ct, batch: int):
    """A GLWE ciphertext repeated to `batch` rows, in contiguous memory."""
    return ct.replace(data=ct.data.expand((batch,) + tuple(ct.data.shape)).contiguous())


def relin_log2_err(m, skp, a, b, prod) -> float:
    """log2 of the largest torus distance between the decryption of `prod`
    and d0 + d1·s + d2·s², the tensor product of `a` and `b` decrypted
    exactly (tests/test_core.py test_tensor_relinearize)."""
    import numpy as np

    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.operations import glwe_tensor_product_big
    from poulpy_tpu_torch.hal import dft
    from poulpy_tpu_torch.hal.normalization import vec_znx_normalize
    from poulpy_tpu_torch.hal.vec_znx import decode_vec_float

    base2k = a.base2k
    have = glwe_decrypt(m, prod, skp)
    lin, quad = glwe_tensor_product_big(m, a, b, a.size + b.size - 1)

    def times_s(big):
        return dft.idft_apply(m, dft.svp_apply(m, dft.dft_apply(m, vec_znx_normalize(base2k, big)),
                                               skp.data[0]))

    total = lin[0] + times_s(lin[1]) + times_s(times_s(quad[(0, 0)]))
    want = dft.big_normalize(m, have.data.shape[-2], base2k, total, base2k)
    err = decode_vec_float(base2k, have.data) - decode_vec_float(base2k, want)
    err -= np.round(err)
    return float(np.log2(max(np.abs(err).max(), 2.0**-200)))


def run_relinearize_path(setup, batch: int, iters: int, fingerprint: int | None) -> None:
    """On the ckks path's set-up: 1 warm-up relinearization of its pair
    broadcast to `batch` rows (fingerprint, rows equal, the algebraic check,
    kernel route == unfused route at batch 8), `iters` timed ones on the
    distinct batches, and one profiled."""
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.core import operations as ops

    m, skp, tsk, _, _, (c1, c2), (t1, t2) = setup
    device = m.device
    a, b = broadcast(c1.glwe, batch), broadcast(c2.glwe, batch)
    out = ops.glwe_tensor_relinearize(m, a, b, tsk)
    data = out.data
    value = int((data[0].abs() % 65536).sum())
    rows_equal = bool((data == data[:1]).all())
    log2_err = relin_log2_err(m, skp, c1.glwe, c2.glwe, out.replace(data=data[0]))
    small = 8
    fused_small = ops.glwe_tensor_relinearize(m, broadcast(c1.glwe, small),
                                              broadcast(c2.glwe, small), tsk)
    fits = ops.tensor_fits
    ops.tensor_fits = lambda *args: False        # the unfused data flow, for comparison
    try:
        unfused = ops.glwe_tensor_relinearize(m, broadcast(c1.glwe, small),
                                              broadcast(c2.glwe, small), tsk)
    finally:
        ops.tensor_fits = fits
    routes_equal = bool(torch.equal(fused_small.data, unfused.data))
    emit(phase="relinearize_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         rows_equal=rows_equal, log2_err_vs_tensor=log2_err, log2_err_max=RELIN_LOG2_ERR_MAX,
         kernel_route_vs_unfused_bit_exact=routes_equal, shape=list(data.shape), k=out.k)
    if (not rows_equal or not routes_equal or log2_err > RELIN_LOG2_ERR_MAX
            or (fingerprint is not None and value != fingerprint)):
        raise SystemExit(f"relinearize warm-up failed: fingerprint {value}, rows equal "
                         f"{rows_equal}, routes equal {routes_equal}, log2 err {log2_err}")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        out = ops.glwe_tensor_relinearize(m, t1.glwe.replace(data=t1.glwe.data[i]),
                                          t2.glwe.replace(data=t2.glwe.data[i]), tsk)
    value = int((out.data.abs() % 65536).sum())
    dt = time.perf_counter() - t0
    per_op = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    emit(phase="relinearize", batch=batch, iters=iters, relins_per_s=batch * iters / dt,
         ms_per_batch=dt / iters * 1e3, checksum=value, launches_per_op=per_op,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if device.type == "cuda" else None)
    if device.type == "cuda":
        profile_once("relinearize_profile",
                     lambda: ops.glwe_tensor_relinearize(m, t1.glwe.replace(data=t1.glwe.data[0]),
                                                         t2.glwe.replace(data=t2.glwe.data[0]),
                                                         tsk), dt / iters * 1e3)


def rotation_keys(setup) -> dict:
    """The automorphism keys of galois_element(1) and −1 from Source 0x05 /
    0x06 (tests/test_ckks.py's seeds) on the ckks path's set-up."""
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.prepared import GLWEAutomorphismKeyPrepared, gglwe_prepare
    from poulpy_tpu_torch.hal.source import Source

    m, cfg = setup[0], CKKS
    sk = enc.secret_new(m, 1, Source(bytes(32)))        # the ckks path's secret, drawn again
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    keys = {}
    for name, p in (("rotate", m.galois_element(1)), ("conjugate", -1)):
        key, _ = enc.glwe_automorphism_key_encrypt_sk(m, p, sk, cfg.base2k, cfg.k_key, cfg.dnum,
                                                      xe, xa)
        keys[name] = GLWEAutomorphismKeyPrepared(key=gglwe_prepare(m, key), p=p)
    return keys


def run_rotate_path(setup, batch: int, iters: int, fingerprints: dict | None,
                    route: str = "fused", keys: dict | None = None) -> tuple:
    """On the ckks path's set-up: the automorphism keys (`rotation_keys`,
    made here unless given), rotate and conjugate of c1 broadcast to
    `batch` rows (fingerprints, rows equal, decode errors), then `iters`
    timed rotations on distinct batches, each keyswitch through `route`.
    Returns the keys and the warm-up's outputs."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.ckks import ops as ck

    m, skp, _, encoder, z, (c1, _), (t1, _) = setup
    device = m.device
    phase = "ckks_rotate" if route == "fused" else f"ckks_rotate_{route}"
    if keys is None:
        t0 = time.perf_counter()
        keys = rotation_keys(setup)
        sync(device)
        emit(phase="ckks_rotate_setup", automorphism_keys_s=time.perf_counter() - t0)
    cb = c1.replace(glwe=broadcast(c1.glwe, batch))
    checks, outs = {}, {}
    for name, want in (("rotate", np.roll(z, -1)), ("conjugate", np.conj(z))):
        data = outs[name] = getattr(ck, name)(m, cb, keys[name], route=route).glwe.data
        row0 = c1.replace(glwe=c1.glwe.replace(data=data[0]))
        checks[name] = dict(fingerprint=int((data[0].abs() % 65536).sum()),
                            rows_equal=bool((data == data[:1]).all()),
                            decode_err=float(np.abs(ck.decode(encoder, ck.decrypt(m, row0, skp))
                                                    - want).max()))
    emit(phase=f"{phase}_warmup", route=route, fingerprints_expected=fingerprints, **checks)
    for name, c in checks.items():
        if (not c["rows_equal"] or c["decode_err"] > 1e-4
                or (fingerprints is not None and c["fingerprint"] != fingerprints[name])):
            raise SystemExit(f"{phase} warm-up failed: {name} {c}")

    def rotate(i):
        return ck.rotate(m, t1.replace(glwe=t1.glwe.replace(data=t1.glwe.data[i])),
                         keys["rotate"], route=route)

    before = dict(LAUNCHES)
    sync(device)
    t0 = time.perf_counter()
    for i in range(iters):
        out = rotate(i)
    value = int((out.glwe.data.abs() % 65536).sum())
    dt = time.perf_counter() - t0
    per_op = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES if LAUNCHES[k] != before[k]}
    emit(phase=phase, route=route, batch=batch, iters=iters, rotations_per_s=batch * iters / dt,
         ms_per_batch=dt / iters * 1e3, checksum=value, launches_per_op=per_op)
    if device.type == "cuda":
        profile_once(f"{phase}_profile", lambda: rotate(0), dt / iters * 1e3)
    return keys, outs


def run_gate_path(device, n_lwe: int, batch: int, verify_batch: int, std_n_lwe: int,
                  iters: int, fingerprint: int | None) -> tuple:
    """The gate path: set-up, gate_verify, gate_bench.  Returns the set-up,
    the bench's gates/s and its launches per NAND, for the MXU gate path and
    the compressed gate path."""
    from poulpy_tpu_torch.binfhe.gates import GateParams

    t0 = time.perf_counter()
    setup = gate_setup(GateParams(n_lwe=n_lwe, block_size=GATE_BLOCK), batch, device)
    sync(device)
    brk = setup[0].brk
    emit(phase="gate_setup", batch=batch, keygen_encrypt_s=time.perf_counter() - t0,
         brk_pmats_mib=brk.pmats.numel() * brk.pmats.element_size() / 2**20)
    phase_gate_verify(setup, GateParams(n_lwe=std_n_lwe, block_size=1), verify_batch)
    return (setup, *phase_gate_bench(setup, iters, fingerprint))


def run_gate_route_path(gate, verify_batch: int, std_n_lwe: int, iters: int,
                        fingerprint: int | None, route: str) -> None:
    """The gate path through `route` on the gate path's set-up: verify at
    `verify_batch`, then the warm-up (fingerprint), the timed chained NANDs
    beside the butterfly's gates/s and a profiled NAND."""
    from poulpy_tpu_torch.binfhe.gates import GateParams

    setup, butterfly_gates_per_s, _ = gate
    phase_gate_verify(setup, GateParams(n_lwe=std_n_lwe, block_size=1), verify_batch, route)
    phase_gate_bench(setup, iters, fingerprint, route, butterfly_gates_per_s)


def cbt_setup(n_lwe: int, block: int, device) -> dict:
    """bench_schemes.py bench_circuit_bootstrap's set-up: Source(bytes(32))
    draws the LWE secret (binary_block for block > 1, else binary_prob) then
    the GLWE secret; the keys, then CBT_ITERS + 1 batches of CBT_BATCH
    encryptions of arange(CBT_BATCH) % 2 at LWE k 13 (the last the warm-up),
    come from Source 0x01 / 0x02; then CBT_WIDE_ITERS batches of
    CBT_WIDE_BATCH from the same sources, and the noiseless GLWE of the
    decrypt check."""
    import numpy as np
    import torch

    from poulpy_tpu_torch.binfhe.circuit_bootstrapping import circuit_bootstrapping_keygen
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.layouts import GLWECiphertext
    from poulpy_tpu_torch.core.prepared import glwe_secret_prepare
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source

    m = get_module(CBT_N, 2, 28, device)
    src, xe, xa = Source(bytes(32)), Source(b"\x01" * 32), Source(b"\x02" * 32)
    sk_lwe = src.binary_block(n_lwe, block) if block > 1 else src.binary_prob((n_lwe,))
    sk = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk)
    k, d = CBT_K_KEY, CBT_DNUM_KEY
    key = circuit_bootstrapping_keygen(m, sk_lwe, sk, skp, CBT_BASE2K, k, d, k, d, k, d, xe, xa,
                                       block_size=block)
    s = torch.from_numpy(sk_lwe).to(m.device)

    def lwes(batch: int, count: int):
        pt = np.zeros((batch, 1, 1), dtype=np.int64)
        pt[:, 0, 0] = (np.arange(batch) % 2) << (CBT_BASE2K - 2)
        return [enc.lwe_encrypt_sk(None, pt, s, CBT_BASE2K, CBT_K_LWE, xe, xa)
                for _ in range(count)]

    ct = torch.zeros((2, 2, m.n), dtype=torch.int64)
    ct[:, 0] = torch.from_numpy(np.random.default_rng(CBT_MSG_SEED).integers(-1, 2, (2, m.n)))
    ct = GLWECiphertext(data=ct.to(m.device), base2k=CBT_BASE2K, k=CBT_K_RES)
    return dict(m=m, skp=skp, key=key, lwes=lwes(CBT_BATCH, CBT_ITERS + 1),
                wide=lwes(CBT_WIDE_BATCH, CBT_WIDE_ITERS), ct=ct)


def cbt(m, key, lwe, extension_factor: int = 1, route: str = "fused"):
    """bench_schemes.py's CBT: to-constant, log_domain 1, GGSW k 26 dnum 2,
    its blind rotation and trace through `route`."""
    from poulpy_tpu_torch.binfhe.circuit_bootstrapping import circuit_bootstrap

    return circuit_bootstrap(m, lwe, CBT_LOG_DOMAIN, key, CBT_DNUM_RES, CBT_K_RES,
                             extension_factor=extension_factor, route=route)


def cbt_decrypt_errors(setup, ggsw, rows) -> list:
    """|decrypt(ct ⊡ GGSW_row) − bit·decrypt(ct)| at the 2^-26 scale, centred
    mod 2^26, for each row of a batch of CBT outputs of the bits arange % 2
    (ct: the set-up's noiseless GLWE)."""
    from poulpy_tpu_torch.core.decryption import glwe_decrypt
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.core.prepared import ggsw_prepare
    from poulpy_tpu_torch.hal import vec_znx

    m, ct, skp = setup["m"], setup["ct"], setup["skp"]
    mod = 1 << CBT_K_RES

    def phase(c):
        return vec_znx.decode_vec_i64(CBT_BASE2K, CBT_K_RES, glwe_decrypt(m, c, skp).data)

    want = phase(ct)
    errs = []
    for row in rows:
        g = ggsw_prepare(m, ggsw.replace(data=ggsw.data[row]))
        err = (phase(glwe_external_product(m, ct, g)) - (row % 2) * want) % mod
        errs.append(int(((err + mod // 2) % mod - mod // 2).abs().max()))
    return errs


def phase_cbt_verify(name: str, setup, batch: int, extended: bool) -> None:
    """The card's CBT of the warm-up batch's first `batch` LWEs equals the
    port's CPU run on the same keys (tolerance 0), through the extended path
    (extension_factor 2) too where asked; three of the GGSWs, prepared,
    take the noiseless GLWE of m to bit·m within CBT_DECRYPT_BOUND."""
    import torch

    from poulpy_tpu_torch.hal.module import get_module

    m, key = setup["m"], setup["key"]
    cpu = torch.device("cpu")
    lwe = setup["lwes"][-1]
    lwe = lwe.replace(data=lwe.data[:batch])
    mc, key_c, lwe_c = get_module(m.n, m.nprimes, 28, cpu), moved(key, cpu), moved(lwe, cpu)
    checks, times = {}, {}
    for ext in (1, 2) if extended else (1,):
        sync(m.device)
        t0 = time.perf_counter()
        have = cbt(m, key, lwe, ext)
        sync(m.device)
        t1 = time.perf_counter()
        want = cbt(mc, key_c, lwe_c, ext)
        times[f"ext{ext}"] = dict(card_s=t1 - t0, cpu_s=time.perf_counter() - t1)
        checks[f"card_vs_cpu_bit_exact_ext{ext}"] = bool(torch.equal(have.data.cpu(), want.data))
        if ext == 1:
            errs = cbt_decrypt_errors(setup, have, range(3))
    checks["decrypt_within_bound"] = max(errs) <= CBT_DECRYPT_BOUND
    emit(phase=f"{name}_verify", batch=batch, decrypt_err=errs, decrypt_bound=CBT_DECRYPT_BOUND,
         seconds=times, **checks)
    if not all(checks.values()):
        raise SystemExit(f"{name} verify failed: {checks}")


def cbt_stages(setup, lwe, route: str = "fused") -> dict:
    """The CBT of `lwe` in its three stages, each a callable of the previous
    stage's output: the blind rotation, the trace of each digit into a
    GGLWE (both through `route`), the GGSW expansion."""
    from poulpy_tpu_torch.binfhe import circuit_bootstrapping as cb
    from poulpy_tpu_torch.binfhe.blind_rotation import blind_rotation_dispatch
    from poulpy_tpu_torch.core.conversion import ggsw_from_gglwe
    from poulpy_tpu_torch.core.layouts import GLWECiphertext

    m, key = setup["m"], setup["key"]
    base2k = key.brk.base2k
    lut = cb._lookup_table(m, base2k, CBT_LOG_DOMAIN, CBT_DNUM_RES, False, 1)
    return {
        "blind_rotation": lambda _: GLWECiphertext(
            data=blind_rotation_dispatch(m, lwe, lut, key.brk, key.block_size, route),
            base2k=base2k, k=lut.size * base2k),
        "trace": lambda acc: cb._gglwe_rows(m, acc, lut, CBT_LOG_DOMAIN, key.atk, CBT_DNUM_RES,
                                            False, route),
        "expansion": lambda gglwe: ggsw_from_gglwe(m, gglwe, key.tsk),
    }


def block_launches(n_lwe: int, block: int, route: str) -> dict:
    """The block-step launches of one block blind rotation on the card, by
    kernel (BLOCK_STEP_KERNELS): on the butterfly kernels the JAX package's
    grouping, nblocks // BR_STEPS chains then nblocks % BR_STEPS single
    steps; through "fused_mxu" one MXU block step per block."""
    from poulpy_tpu_torch.binfhe.blind_rotation import BR_STEPS

    nblocks = n_lwe // block
    out = dict.fromkeys(BLOCK_STEP_KERNELS, 0)
    if route == "fused_mxu":
        out["fused_mxu_br_block_step"] = nblocks
    else:
        steps = min(BR_STEPS, nblocks)
        out.update(br_block_chain=nblocks // steps if steps > 1 else 0,
                   br_block_step=nblocks % steps if steps > 1 else nblocks)
    return out


def br_launches(setup, route: str) -> dict | None:
    """The launches of the blind rotation on the butterfly kernels (the
    default and "mxu" routes) on the card, and nothing else of csrc/: one
    folded step per LWE coefficient on the standard path, the block steps
    of `block_launches` on the block path; None through "fused_mxu"."""
    key = setup["key"]
    if route == "fused_mxu":
        return None
    if key.block_size == 1:
        return {"fused_br_step": key.brk.n_lwe}
    return {k: v for k, v in block_launches(key.brk.n_lwe, key.block_size, route).items() if v}


def cbt_split(setup, lwe, timed_ms: float, route: str = "fused") -> dict:
    """One CBT in its stages with the device synchronised between them: each
    stage's milliseconds, share and launches, the result equal to
    `circuit_bootstrap`'s (a line for `emit`, without the device times)."""
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES

    m = setup["m"]
    x, stages = None, {}
    for stage, fn in cbt_stages(setup, lwe, route).items():
        before = dict(LAUNCHES)
        sync(m.device)
        t0 = time.perf_counter()
        x = fn(x)
        sync(m.device)
        stages[stage] = dict(ms=(time.perf_counter() - t0) * 1e3, launches={
            k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]})
    total = sum(v["ms"] for v in stages.values())
    for v in stages.values():
        v["share"] = v["ms"] / total
    equal = bool(torch.equal(x.data, cbt(m, setup["key"], lwe, route=route).data))
    if not equal:
        raise SystemExit("the staged CBT differs from circuit_bootstrap")
    want = br_launches(setup, route)
    br = stages["blind_rotation"]["launches"]
    if want is not None and m.device.type == "cuda" and br != want:
        raise SystemExit(f"the blind rotation launched {br}, not {want}")
    return dict(batch=lwe.data.shape[0], staged_ms=total, timed_ms=timed_ms, stages=stages,
                staged_equals_cbt=equal)


def cbt_split_profile(name: str, setup, lwe, split: dict, route: str = "fused") -> None:
    """Each stage of `cbt_split` once more under the profiler (device busy
    time, its share of the stage's unprofiled time), then the split's line."""
    x, busy = None, 0.0
    folded = (br_launches(setup, route) or {}).get("fused_br_step")
    for stage, fn in cbt_stages(setup, lwe, route).items():
        row = split["stages"][stage]
        prof = profile_once(f"{name}_{stage}_profile", lambda f=fn, v=x: f(v), row["ms"])
        row.update(device_busy_ms=prof["device_busy_ms"],
                   busy_share=prof["device_busy_ms"] / row["ms"],
                   device_events=prof["device_events"])
        busy += prof["device_busy_ms"]
        x = fn(x)
        # the folded steps leave the blind rotation only its set-up and final
        # normalization around them: no elementwise op per coefficient
        if stage == "blind_rotation" and folded and \
                prof["device_events"] > folded + CBT_BR_GLUE_EVENTS:
            raise SystemExit(f"{name}: the blind rotation ran {prof['device_events']} device "
                             "events: per-step glue")
    emit(phase=f"{name}_split", **split, device_busy_ms=busy,
         device_busy_share=busy / split["staged_ms"])


def phase_cbt_bench(name: str, setup, fingerprint: int | None, route: str = "fused") -> None:
    """bench_schemes.py's timing through `route` at CBT_BATCH: 1 warm-up (its
    fingerprint), CBT_ITERS runs on distinct encrypted batches ending in a host checksum;
    then CBT_WIDE_ITERS runs at CBT_WIDE_BATCH (after a warm-up on the first
    batch), sampled rows decrypt-checked; the split at each batch; then,
    after every timing, a profiled CBT and the split's profiles."""
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES

    m, key = setup["m"], setup["key"]
    cuda = m.device.type == "cuda"

    def checksum(outs):
        return sum(int((o.data.abs() % 65536).sum()) for o in outs)

    def run(lwe):
        return cbt(m, key, lwe, route=route)

    out = run(setup["lwes"][-1])
    value = checksum([out])
    emit(phase=f"{name}_warmup", fingerprint=value, fingerprint_expected=fingerprint,
         shape=list(out.data.shape))
    if fingerprint is not None and value != fingerprint:
        raise SystemExit(f"{name} warm-up: fingerprint {value} != {fingerprint}")
    splits = {}
    for batch, lwes in ((CBT_BATCH, setup["lwes"][:CBT_ITERS]), (CBT_WIDE_BATCH, setup["wide"])):
        if batch == CBT_WIDE_BATCH:
            checksum([run(lwes[0])])
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        before = dict(LAUNCHES)
        sync(m.device)
        t0 = time.perf_counter()
        outs = [run(lwe) for lwe in lwes]
        value = checksum(outs)
        dt = time.perf_counter() - t0
        iters = len(lwes)
        per_cbt = {k: (LAUNCHES[k] - before[k]) / iters for k in LAUNCHES
                   if LAUNCHES[k] != before[k]}
        extra = {}
        if batch == CBT_WIDE_BATCH:
            rows = (0, 1, batch // 2 + 1, batch - 2)
            extra = dict(decrypt_rows=rows, decrypt_err=cbt_decrypt_errors(setup, outs[-1], rows))
        emit(phase=f"{name}_bench", batch=batch, iters=iters, cbt_per_s=batch * iters / dt,
             ms_per_batch=dt / iters * 1e3, checksum=value, launches_per_batch=per_cbt,
             peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None, **extra)
        if extra and max(extra["decrypt_err"]) > CBT_DECRYPT_BOUND:
            raise SystemExit(f"{name}: rows {rows} decrypt {extra['decrypt_err']} away")
        del outs
        splits[batch] = (lwes[0], cbt_split(setup, lwes[0], dt / iters * 1e3, route))
    if cuda:
        lwe, split = splits[CBT_BATCH]
        profile_once(f"{name}_profile", lambda: run(lwe), split["timed_ms"])
    for batch, (lwe, split) in splits.items():
        if cuda:
            cbt_split_profile(f"{name}_b{batch}", setup, lwe, split, route)
        else:
            emit(phase=f"{name}_b{batch}_split", **split)


def run_cbt_path(name: str, n_lwe: int, block: int, device, fingerprint: int | None,
                 extended: bool) -> dict:
    """A circuit-bootstrapping path: set-up, verify at CBT_VERIFY_BATCH,
    then the bench at CBT_BATCH and CBT_WIDE_BATCH.  Returns the set-up (for
    the mesh path)."""
    import torch

    t0 = time.perf_counter()
    setup = cbt_setup(n_lwe, block, device)
    sync(device)
    brk = setup["key"].brk
    emit(phase=f"{name}_setup", n_lwe=n_lwe, block_size=block,
         keygen_encrypt_s=time.perf_counter() - t0,
         brk_pmats_mib=brk.pmats.numel() * brk.pmats.element_size() / 2**20,
         allocated_gib=torch.cuda.memory_allocated() / 2**30 if device.type == "cuda" else None)
    phase_cbt_verify(name, setup, CBT_VERIFY_BATCH, extended)
    phase_cbt_bench(name, setup, fingerprint)
    return setup


def run_cbt_route_path(name: str, setup, route: str, fingerprint: int | None) -> None:
    """A circuit-bootstrapping path through `route` on an earlier CBT path's
    set-up: the card's CBT of the warm-up batch's first CBT_VERIFY_BATCH
    LWEs through the route equals the default route's (tolerance 0) and
    three of its GGSWs decrypt within CBT_DECRYPT_BOUND; then the bench
    (the fingerprint, batch 32 and 1024, the split, the profiles) through
    the route."""
    import torch

    m, key = setup["m"], setup["key"]
    lwe = setup["lwes"][-1]
    lwe = lwe.replace(data=lwe.data[:CBT_VERIFY_BATCH])
    want = cbt(m, key, lwe)
    sync(m.device)
    t0 = time.perf_counter()
    have = cbt(m, key, lwe, route=route)
    sync(m.device)
    card_s = time.perf_counter() - t0
    errs = cbt_decrypt_errors(setup, have, range(3))
    checks = dict(route_equals_default=bool(torch.equal(have.data, want.data)),
                  decrypt_within_bound=max(errs) <= CBT_DECRYPT_BOUND)
    emit(phase=f"{name}_verify", route=route, batch=CBT_VERIFY_BATCH, card_s=card_s,
         decrypt_err=errs, decrypt_bound=CBT_DECRYPT_BOUND, **checks)
    if not all(checks.values()):
        raise SystemExit(f"{name} verify failed: {checks}")
    phase_cbt_bench(name, setup, fingerprint, route)


def plain_semantics(op: str, a: int, b: int, w: int) -> int:
    """Python's int semantics of each BDD op at width w (a copy of
    tests/test_bdd_circuits.py's oracle): shift amounts are the low log2(w)
    bits of b, slt compares signed, sra fills with the sign."""
    mask = (1 << w) - 1
    amt = b & ((1 << (w - 1).bit_length()) - 1)

    def signed(x):
        return x - (1 << w) if x & (1 << (w - 1)) else x

    return {
        "add": lambda: (a + b) & mask, "sub": lambda: (a - b) & mask,
        "and": lambda: a & b, "or": lambda: a | b, "xor": lambda: a ^ b,
        "slt": lambda: int(signed(a) < signed(b)), "sltu": lambda: int(a < b),
        "sll": lambda: (a << amt) & mask, "srl": lambda: a >> amt,
        "sra": lambda: (signed(a) >> amt) & mask, "identity": lambda: a,
    }[op]()


def cmux_count(op: str, width: int) -> int:
    """The CMuxes `fheuint_op` evaluates: the nodes reachable from each
    output bit's root."""
    from poulpy_tpu_torch.binfhe.bdd import bdd_circuit

    total = 0
    for bdd in bdd_circuit(op, width):
        seen, todo = set(), [bdd.root]
        while todo:
            ref = todo.pop()
            if ref < 0 or ref in seen:
                continue
            seen.add(ref)
            todo += bdd.nodes[ref][1:]
        total += len(seen)
    return total


def bdd_setup(device) -> dict:
    """bench_schemes.py bench_u32_add's set-up: Source(bytes(32)) draws the
    block-binary LWE secret then the GLWE secret; from Source 0x03 / 0x04
    the CBT key, the GLWE → LWE key, then the operands 255, 30 and 77 at
    width 32; then a public key (Source 0x05 / 0x06)."""
    import torch

    from poulpy_tpu_torch.binfhe.bdd import BDDKey, fheuint_encrypt
    from poulpy_tpu_torch.binfhe.circuit_bootstrapping import circuit_bootstrapping_keygen
    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.conversion import glwe_to_lwe_key_encrypt_sk
    from poulpy_tpu_torch.core.prepared import glwe_secret_prepare
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source

    m = get_module(BDD_N, 2, 28, device)
    src, xe, xa = Source(bytes(32)), Source(b"\x03" * 32), Source(b"\x04" * 32)
    sk_lwe = src.binary_block(BDD_N_LWE, BDD_BLOCK)
    sk = enc.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk)
    k, d = BDD_K_CBT, BDD_DNUM_CBT
    cbt_key = circuit_bootstrapping_keygen(m, sk_lwe, sk, skp, BDD_BASE2K, k, d, k, d, k, d, xe,
                                           xa, block_size=BDD_BLOCK)
    ks_lwe = glwe_to_lwe_key_encrypt_sk(m, torch.from_numpy(sk_lwe).to(m.device), sk, BDD_BASE2K,
                                        BDD_K_CT, dnum=BDD_DNUM_KS, source_xe=xe, source_xa=xa)
    key = BDDKey(cbt=cbt_key, ks_lwe=ks_lwe, n_lwe=BDD_N_LWE, base2k=BDD_BASE2K, k_ct=BDD_K_CT,
                 dnum_ggsw=BDD_DNUM_GGSW, k_ggsw=BDD_K_GGSW)
    cts = [fheuint_encrypt(m, v, BDD_WIDTH, skp, BDD_BASE2K, BDD_K_CT, xe, xa)
           for v in BDD_VALUES]
    return dict(m=m, sk=sk, skp=skp, key=key, cts=cts)


def pk_encrypt(m, skp, value: int):
    """A public key of `skp` (k 30, Source 0x05 / 0x06) and the public-key
    encryption of `value`'s BDD_WIDTH bits at torus 1/4 (u from Source 0x0b,
    the noise from 0x06)."""
    import torch

    from poulpy_tpu_torch.core import encryption as enc
    from poulpy_tpu_torch.core.layouts import GLWEPlaintext
    from poulpy_tpu_torch.hal import vec_znx
    from poulpy_tpu_torch.hal.source import Source

    xe, xa, xu = Source(b"\x05" * 32), Source(b"\x06" * 32), Source(b"\x0b" * 32)
    pk = enc.glwe_public_key_generate(m, skp, BDD_BASE2K, BDD_K_CT, xe, xa)
    pkp = enc.glwe_public_key_prepare(m, pk)
    bits = torch.zeros(m.n, dtype=torch.int64)
    bits[:BDD_WIDTH] = torch.tensor([(value >> j) & 1 for j in range(BDD_WIDTH)])
    pt = GLWEPlaintext(data=vec_znx.encode_vec_i64(BDD_BASE2K, 2, 1, bits.to(m.device)),
                       base2k=BDD_BASE2K, k=2)
    return enc.glwe_encrypt_pk(m, pt, pkp, BDD_BASE2K, BDD_K_CT, xu, xe)


def phase_bdd_verify(setup) -> None:
    """Card == the port's CPU run: the public-key encryption (which must
    decrypt exactly), the prepare of a BDD_VERIFY_WIDTH-bit FheUint, and
    the add of the full-width prepared operands moved to the CPU."""
    import torch

    from poulpy_tpu_torch.binfhe.bdd import FheUint, fheuint_decrypt, fheuint_op, fheuint_prepare
    from poulpy_tpu_torch.hal.module import get_module

    m, key, skp = setup["m"], setup["key"], setup["skp"]
    cpu = torch.device("cpu")
    mc, key_c, skp_c = get_module(m.n, m.nprimes, 28, cpu), moved(key, cpu), moved(skp, cpu)
    checks, seconds = {}, {}
    pk_value = 0xDEADBEEF
    ct = pk_encrypt(m, skp, pk_value)
    checks["pk_card_vs_cpu_bit_exact"] = bool(torch.equal(ct.data.cpu(),
                                                          pk_encrypt(mc, skp_c, pk_value).data))
    checks["pk_decrypts_exactly"] = fheuint_decrypt(m, FheUint(glwe=ct, width=BDD_WIDTH),
                                                    skp) == pk_value
    small = FheUint(glwe=setup["cts"][0].glwe, width=BDD_VERIFY_WIDTH)
    t0 = time.perf_counter()
    have = fheuint_prepare(m, small, key)
    sync(m.device)
    t1 = time.perf_counter()
    want = fheuint_prepare(mc, moved(small, cpu), key_c)
    seconds["prepare"] = dict(card_s=t1 - t0, cpu_s=time.perf_counter() - t1)
    checks["prepare_card_vs_cpu_bit_exact"] = all(
        torch.equal(h.pmat.cpu(), w.pmat) for h, w in zip(have.bits, want.bits, strict=True))
    pa, pb = setup["prepared"][:2]
    t0 = time.perf_counter()
    have = fheuint_op(m, "add", pa, pb, BDD_BASE2K, BDD_K_CT)
    sync(m.device)
    t1 = time.perf_counter()
    want = fheuint_op(mc, "add", moved(pa, cpu), moved(pb, cpu), BDD_BASE2K, BDD_K_CT)
    seconds["add"] = dict(card_s=t1 - t0, cpu_s=time.perf_counter() - t1)
    checks["add_card_vs_cpu_bit_exact"] = bool(torch.equal(have.data.cpu(), want.data))
    emit(phase="fheuint_add_verify", verify_width=BDD_VERIFY_WIDTH, seconds=seconds, **checks)
    if not all(checks.values()):
        raise SystemExit(f"fheuint_add verify failed: {checks}")


def phase_bdd_bench(setup, fingerprint: int | None, route: str = "fused") -> float:
    """bench_schemes.py's timing, every CMux through `route`: 1 warm-up add
    255 + 30 (its fingerprint, decrypting to 285), 3 timed adds on its
    distinct pairs ending in a host checksum, each decrypted; launches per
    add (the route's product kernel, CMUX_KERNEL, must equal the CMuxes the
    circuit evaluates); a profiled add; then each of the ten other ops once
    on (255, 30), decrypted against Python's ints.  Returns the ms per add."""
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.binfhe.bdd import FheUint, bdd_circuit, fheuint_decrypt, fheuint_op

    m, skp, prepared = setup["m"], setup["skp"], setup["prepared"]
    cuda = m.device.type == "cuda"
    name_ = "fheuint_add" if route == "fused" else f"fheuint_add_{route}"
    kernel = CMUX_KERNEL[route]

    def op(name, a, b):
        return fheuint_op(m, name, prepared[a], prepared[b], BDD_BASE2K, BDD_K_CT, route)

    def value(out, width=BDD_WIDTH):
        return fheuint_decrypt(m, FheUint(glwe=out, width=width), skp)

    def checksum(outs):
        return sum(int((o.data.abs() % 65536).sum()) for o in outs)

    cmuxes = cmux_count("add", BDD_WIDTH)
    out = op("add", 0, 1)
    fp, got = checksum([out]), value(out)
    emit(phase=f"{name_}_warmup", route=route, fingerprint=fp, fingerprint_expected=fingerprint,
         decrypted=got, cmuxes=cmuxes, shape=list(out.data.shape))
    if fingerprint is not None and fp != fingerprint:
        raise SystemExit(f"{name_} warm-up: fingerprint {fp} != {fingerprint}")
    if got != plain_semantics("add", BDD_VALUES[0], BDD_VALUES[1], BDD_WIDTH) \
            or cmuxes != FHEUINT_ADD_CMUXES:
        raise SystemExit(f"{name_} warm-up: {got}, {cmuxes} CMuxes")
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    before = dict(LAUNCHES)
    sync(m.device)
    t0 = time.perf_counter()
    outs = [op("add", a, b) for a, b in BDD_PAIRS]
    total = checksum(outs)
    dt = time.perf_counter() - t0
    per_add = {k: (LAUNCHES[k] - before[k]) / len(BDD_PAIRS) for k in LAUNCHES
               if LAUNCHES[k] != before[k]}
    got = [value(o) for o in outs]
    want = [plain_semantics("add", BDD_VALUES[a], BDD_VALUES[b], BDD_WIDTH) for a, b in BDD_PAIRS]
    ms = add_ms = dt / len(BDD_PAIRS) * 1e3
    emit(phase=f"{name_}_bench", route=route, width=BDD_WIDTH, iters=len(BDD_PAIRS),
         ms_per_add=ms,
         adds_per_s=1e3 / ms, checksum=total, decrypted=got, expected=want,
         launches_per_add=per_add, cmuxes=cmuxes,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)
    if got != want:
        raise SystemExit(f"{name_}: the timed adds decrypt to {got}, not {want}")
    if cuda and per_add.get(kernel) != cmuxes:
        raise SystemExit(f"{name_}: {per_add.get(kernel)} {kernel} launches per add, not one "
                         f"per CMux ({cmuxes})")
    del outs
    if cuda:
        profile_once(f"{name_}_profile", lambda: op("add", 0, 1), ms)
    rows = {}
    for name in ("sub", "and", "or", "xor", "slt", "sltu", "sll", "srl", "sra", "identity"):
        before = dict(LAUNCHES)
        sync(m.device)
        t0 = time.perf_counter()
        out = op(name, 0, 1)
        sync(m.device)
        ms = (time.perf_counter() - t0) * 1e3
        got = value(out, len(bdd_circuit(name, BDD_WIDTH)))
        want = plain_semantics(name, BDD_VALUES[0], BDD_VALUES[1], BDD_WIDTH)
        rows[name] = dict(ms=ms, decrypted=got, expected=want, cmuxes=cmux_count(name, BDD_WIDTH),
                          cmux_launches=LAUNCHES[kernel] - before[kernel])
    emit(phase="fheuint_ops" if route == "fused" else f"fheuint_ops_{route}", route=route,
         width=BDD_WIDTH, operands=list(BDD_VALUES[:2]), ops=rows)
    wrong = [k for k, v in rows.items() if v["decrypted"] != v["expected"]
             or (cuda and v["cmux_launches"] != v["cmuxes"])]
    if wrong:
        raise SystemExit(f"fheuint ops wrong at width {BDD_WIDTH} through {route}: {wrong}")
    return add_ms


def run_fheuint_add_path(device, fingerprint: int | None) -> dict:
    """The u32 add path: set-up (seconds), the three operands prepared
    (seconds per operand), verify, bench.  Returns the set-up for the
    blind_retrieval path."""
    import torch

    from poulpy_tpu_torch.binfhe.bdd import fheuint_prepare

    t0 = time.perf_counter()
    setup = bdd_setup(device)
    sync(device)
    setup_s = time.perf_counter() - t0
    brk = setup["key"].cbt.brk
    emit(phase="fheuint_add_setup", n_lwe=BDD_N_LWE, block_size=BDD_BLOCK,
         keygen_encrypt_s=setup_s,
         brk_pmats_mib=brk.pmats.numel() * brk.pmats.element_size() / 2**20,
         allocated_gib=torch.cuda.memory_allocated() / 2**30 if device.type == "cuda" else None)
    seconds = []
    setup["prepared"] = []
    for ct in setup["cts"]:
        t0 = time.perf_counter()
        setup["prepared"].append(fheuint_prepare(setup["m"], ct, setup["key"]))
        sync(device)
        seconds.append(time.perf_counter() - t0)
    emit(phase="fheuint_prepare", width=BDD_WIDTH, seconds_per_operand=seconds)
    phase_bdd_verify(setup)
    phase_bdd_bench(setup, fingerprint)
    return setup


def run_blind_retrieval_path(setup, route: str = "fused") -> dict:
    """On the u32 add path's keys: a table of BR_ENTRIES FheUint u32 GLWEs
    (values from default_rng(BR_SEED), encrypted from Source 0x07 / 0x08),
    read at the encrypted BR_INDEX_WIDTH-bit index BR_INDEX (encrypted from
    Source 0x09 / 0x0a, prepared by `fheuint_prepare`): the streaming
    retriever equals `blind_select` bit for bit and decrypts to the entry;
    the butterfly puts it at position 0 and its reverse restores every
    position; each with its milliseconds and launches, every product,
    keyswitch and block step through `route`.  Returns the outputs."""
    import numpy as np

    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.binfhe import blind_retrieval as br
    from poulpy_tpu_torch.binfhe.bdd import (
        FheUint,
        blind_select,
        fheuint_decrypt,
        fheuint_encrypt,
        fheuint_prepare,
    )
    from poulpy_tpu_torch.hal.source import Source

    m, skp, key = setup["m"], setup["skp"], setup["key"]
    values = [int(v) for v in np.random.default_rng(BR_SEED).integers(0, 2**32, BR_ENTRIES)]
    xe, xa = Source(b"\x07" * 32), Source(b"\x08" * 32)
    t0 = time.perf_counter()
    table = [fheuint_encrypt(m, v, BDD_WIDTH, skp, BDD_BASE2K, BDD_K_CT, xe, xa).glwe
             for v in values]
    idx = fheuint_encrypt(m, BR_INDEX, BR_INDEX_WIDTH, skp, BDD_BASE2K, BDD_K_CT,
                          Source(b"\x09" * 32), Source(b"\x0a" * 32))
    sync(m.device)
    encrypt_s = time.perf_counter() - t0

    def value(glwe):
        return fheuint_decrypt(m, FheUint(glwe=glwe, width=BDD_WIDTH), skp)

    rows = {}

    def timed(name, fn):
        before = dict(LAUNCHES)
        sync(m.device)
        t0 = time.perf_counter()
        out = fn()
        sync(m.device)
        rows[name] = dict(ms=(time.perf_counter() - t0) * 1e3, launches={
            k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]})
        return out

    sel = timed("prepare_index", lambda: fheuint_prepare(m, idx, key, route))
    stream = timed("retriever", lambda: br.GLWEBlindRetriever(BR_ENTRIES, route).retrieve(
        m, table, sel))
    flat = timed("blind_select", lambda: blind_select(m, sel, table, route))
    res = timed("blind_retrieval", lambda: br.glwe_blind_retrieval(m, table, sel, route=route))
    back = timed("blind_retrieval_rev", lambda: br.glwe_blind_retrieval_rev(m, res, sel,
                                                                            route=route))
    want = values[BR_INDEX]
    checks = dict(retriever_equals_blind_select=bool((stream.data == flat.data).all()),
                  retriever_decrypts=value(stream) == want,
                  retrieval_position_0=value(res[0]) == want,
                  rev_restores_every_position=[value(c) for c in back] == values)
    name = "blind_retrieval" if route == "fused" else f"blind_retrieval_{route}"
    emit(phase=name, route=route, entries=BR_ENTRIES, index_width=BR_INDEX_WIDTH, index=BR_INDEX,
         entry=want, encrypt_s=encrypt_s, **rows, **checks)
    if not all(checks.values()):
        raise SystemExit(f"{name} failed: {checks}")
    return dict(selector=[b.pmat for b in sel.bits], retriever=stream.data, blind_select=flat.data,
                blind_retrieval=[c.data for c in res], blind_retrieval_rev=[c.data for c in back])


def run_fheuint_route_path(setup, route: str, fingerprint: int | None) -> None:
    """The u32 add path through `route` on the default path's set-up: the
    three operands prepared through the route (seconds per operand, the
    selectors equal to the default route's, tolerance 0), then the bench
    through it; last, the σ kernel layout of a selector that the fused MXU
    product rebuilds on every CMux (`pm_kernel_layout` of the σ-permuted
    matrix, CUDA events) and its share of an add."""
    import torch

    from poulpy_tpu_torch.backends.fused import pm_kernel_layout
    from poulpy_tpu_torch.backends.mxu import sigma_index
    from poulpy_tpu_torch.binfhe.bdd import fheuint_prepare
    from poulpy_tpu_torch.core.layouts import glwe_size

    m, key = setup["m"], setup["key"]
    seconds, prepared = [], []
    for ct in setup["cts"]:
        t0 = time.perf_counter()
        prepared.append(fheuint_prepare(m, ct, key, route))
        sync(m.device)
        seconds.append(time.perf_counter() - t0)
    equal = all(torch.equal(h.pmat, w.pmat) for p, q in zip(prepared, setup["prepared"])
                for h, w in zip(p.bits, q.bits, strict=True))
    emit(phase=f"fheuint_prepare_{route}", route=route, width=BDD_WIDTH,
         seconds_per_operand=seconds, equals_default=equal)
    if not equal:
        raise SystemExit(f"fheuint_prepare through {route} differs from the default route's")
    ms = phase_bdd_bench(dict(setup, prepared=prepared), fingerprint, route)
    if route == "fused_mxu" and m.device.type == "cuda":
        sel = prepared[0].bits[0].pmat
        sig, rmax = sigma_index(m.tables), min(sel.shape[0], glwe_size(BDD_BASE2K, BDD_K_CT))
        relayout = cuda_ms(lambda: pm_kernel_layout(sel[..., sig], rmax), 20)
        emit(phase="fheuint_add_fused_mxu_relayout", ms_per_relayout=relayout,
             relayouts_per_add=FHEUINT_ADD_CMUXES, ms_per_add=relayout * FHEUINT_ADD_CMUXES,
             share_of_add=relayout * FHEUINT_ADD_CMUXES / ms)


def run_routes_path(bdd, ckks) -> None:
    """Blind retrieval of BR_ENTRIES entries on the u32 add path's keys and
    CKKS rotate / conjugate on the ckks path's set-up, each through the
    default route, then through each MXU route, then through the default
    route again (its rates before and after the routes'): every output of
    a route equal to the default route's (tolerance 0), the rotation
    fingerprints on each."""
    import torch

    def same(a, b):
        if isinstance(a, list):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        return bool(torch.equal(a, b))

    want = run_blind_retrieval_path(bdd)
    checks = {}
    for route in ROUTES:
        have = run_blind_retrieval_path(bdd, route)
        checks[f"blind_retrieval_{route}"] = {k: same(have[k], v) for k, v in want.items()}
        del have
    run_blind_retrieval_path(bdd)
    del want
    fingerprints = {"rotate": ROTATE_FINGERPRINT, "conjugate": CONJUGATE_FINGERPRINT}
    keys, want = run_rotate_path(ckks, CKKS_BATCH, CKKS_ITERS, fingerprints)
    for route in ROUTES:
        _, have = run_rotate_path(ckks, CKKS_BATCH, CKKS_ITERS, fingerprints, route, keys)
        checks[f"ckks_rotate_{route}"] = {k: same(have[k], v) for k, v in want.items()}
    run_rotate_path(ckks, CKKS_BATCH, CKKS_ITERS, fingerprints, keys=keys)
    emit(phase="routes_equal_default", **checks)
    wrong = [k for k, v in checks.items() if not all(v.values())]
    if wrong:
        raise SystemExit(f"routes: outputs differ from the default route's: {wrong}")


def run_examples_path(device) -> None:
    """The ten port examples (`poulpy_tpu_torch/examples/`) on the card,
    through the default route and "fused_mxu", each run's result lines
    holding the numbers of the same example's CPU run; seconds per run."""
    import contextlib
    import importlib
    import io

    from poulpy_tpu_torch.examples import NAMES
    from poulpy_tpu_torch.examples._common import numbers

    rows = {}
    for name in NAMES:
        main = importlib.import_module(f"poulpy_tpu_torch.examples.{name}").main
        runs, seconds = {}, {}
        with contextlib.redirect_stdout(io.StringIO()):
            for where, route in (("cpu", "fused"), ("card", "fused"), ("card", "fused_mxu")):
                sync(device)
                t0 = time.perf_counter()
                runs[where, route] = main(device="cpu" if where == "cpu" else device, route=route)
                sync(device)
                seconds[f"{where}_{route}"] = time.perf_counter() - t0
        want = numbers(runs["cpu", "fused"])
        rows[name] = dict(seconds=seconds, lines=runs["cpu", "fused"],
                          equal_cpu={route: numbers(runs["card", route]) == want
                                     for route in ("fused", "fused_mxu")})
    emit(phase="examples", card=card_label() if device.type == "cuda" else "cpu", **rows)
    wrong = [k for k, v in rows.items() if not all(v["equal_cpu"].values())]
    if wrong:
        raise SystemExit(f"examples: the card's result lines differ from the CPU's: {wrong}")


def bdd_cases(gm) -> tuple:
    """The butterfly kernels of the u32 add path against their plain
    versions (cases, parents for `check_kernels`), on `gm` (get_module(1024,
    2, 28)) with inputs of their own; prints the instance each takes first:
    the CMux product (a ciphertext of 2 limbs by a selector of dnum 3, psize
    3) unbatched as the evaluator calls it and stacked at batch 64; the
    GLWE → LWE keyswitch of `fheuint_prepare` at batch 32 (2 limbs, key
    dnum 2, psize 2, with the body); the CBT trace's keyswitch at batch 32
    (3 limbs, key dnum 4, psize 4); the block step of 7 key elements at
    batch 32 (accumulator of 3 limbs, key dnum 4, psize 4), and the chain of
    BR_STEPS such steps in one launch."""
    import torch

    from poulpy_tpu_torch.backends import fused
    from poulpy_tpu_torch.binfhe.blind_rotation import BR_STEPS

    gen = torch.Generator(device=gm.device).manual_seed(7)

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=gm.device, dtype=torch.int64)

    def residues(shape):
        primes = torch.tensor(gm.basis.primes, device=gm.device)[:, None]
        return (ints(0, 1 << 62, shape) % primes).to(torch.int32)

    gn, gp, i32, i64, b2k = gm.n, gm.nprimes, 4, 8, BDD_BASE2K
    phase_instances(gm, "bdd_instances", (
        ("fused_product@cmux", "product", 4, 3, 2, 0),
        ("fused_product_small@fheuint_ks", "product", 2, 2, 2, 0),
        ("fused_product_small@fheuint_trace", "product", 3, 4, 3, 0),
        ("br_block_step@fheuint", "block_step", 6, 4, 3, BDD_BLOCK),
        ("br_block_chain@fheuint", "block_chain", 6, 4, 3, BR_STEPS * BDD_BLOCK)))
    cmux_pmat = residues((BDD_DNUM_GGSW, 2, 2, 3, gp, gn))
    cmux1 = ints(-(2**15), 2**15, (2, 2, gn))
    cmux64 = ints(-(2**15), 2**15, (64, 2, 2, gn))
    ks_a, ks_body = ints(-(2**14), 2**14, (32, 1, 2, gn)), ints(-(2**14), 2**14, (32, 2, gn))
    ks_pmat = residues((BDD_DNUM_KS, 1, 2, 2, gp, gn))
    tr_a, tr_body = ints(-(2**14), 2**14, (32, 1, 3, gn)), ints(-(2**14), 2**14, (32, 3, gn))
    tr_pmat = residues((BDD_DNUM_CBT, 1, 2, 4, gp, gn))
    acc = ints(-(2**14), 2**14, (32, 2, 3, gn))
    brk = residues((BDD_BLOCK, BDD_DNUM_CBT, 2, 2, 4, gp, gn))
    amounts = ints(-gn, gn + 1, (32, BDD_BLOCK))
    pm_k = fused.pm_kernel_layout(brk, 3)
    rows_used = int(torch.unique(amounts & (2 * gn - 1)).numel())
    chain_brk = residues((BR_STEPS * BDD_BLOCK, BDD_DNUM_CBT, 2, 2, 4, gp, gn))
    chain_amounts = ints(-gn, gn + 1, (32, BR_STEPS * BDD_BLOCK))
    chain_pm_k = fused.pm_kernel_layout(chain_brk, 3)
    chain_rows_used = int(torch.unique(chain_amounts & (2 * gn - 1)).numel())
    product, step = fused._product_launch, fused._block_step_launch
    args = {
        "fused_product@cmux": (cmux1, cmux_pmat, 2, None),
        "fused_product@cmux64": (cmux64, cmux_pmat, 2, None),
        "fused_product_small@fheuint_ks": (ks_a, ks_pmat, 2, ks_body),
        "fused_product_small@fheuint_trace": (tr_a, tr_pmat, 3, tr_body),
    }
    cases, parents = {}, {}
    for name, (a, pmat, res, body) in args.items():
        B = a.numel() // (a.shape[-3] * a.shape[-2] * gn)
        kk, mdim = a.shape[-3] * min(pmat.shape[0], a.shape[-2]), 2 * pmat.shape[3]
        out_bytes = B * 2 * res * gn * i64
        body_bytes = 0 if body is None else body.numel() * i64
        cases[name] = (
            lambda a=a, pmat=pmat, res=res, body=body: fused.fused_glwe_product(
                gm, a, pmat, res, b2k, b2k, small=body),
            lambda a=a, pmat=pmat, res=res, body=body: fused.fused_glwe_product_ref(
                gm, a, pmat, res, b2k, b2k, small=body),
            bound(a.numel() * i64 + body_bytes + out_bytes
                  + pmat[:min(pmat.shape[0], a.shape[-2])].numel() * i32,
                  fused_ops(B, kk, mdim, gp, gn)))
        parents[name] = parent_run(product, gm, a, pmat, res, b2k, b2k, 1, body)
    cases["br_block_step@fheuint"] = (
        lambda: fused.fused_br_block_step(gm, acc, brk, amounts, 3, b2k, pm_k),
        lambda: fused.fused_br_block_step_ref(gm, acc, brk, amounts, 3, b2k),
        bound(2 * acc.numel() * i64 + amounts.numel() * i64 + pm_k.numel() * i32
              + rows_used * gp * gn * i32, fused_ops(32, 6, 8, gp, gn, BDD_BLOCK)))
    parents["br_block_step@fheuint"] = parent_run(step, gm, acc, brk, amounts, 3, b2k, pm_k)
    cases["br_block_chain@fheuint"] = (
        lambda: fused.fused_br_block_step(gm, acc, chain_brk, chain_amounts, 3, b2k, chain_pm_k,
                                          BR_STEPS),
        lambda: fused.fused_br_block_step_ref(gm, acc, chain_brk, chain_amounts, 3, b2k,
                                              BR_STEPS),
        bound(2 * acc.numel() * i64 + chain_amounts.numel() * i64 + chain_pm_k.numel() * i32
              + chain_rows_used * gp * gn * i32,
              BR_STEPS * fused_ops(32, 6, 8, gp, gn, BDD_BLOCK)))
    return cases, parents


def blob_digest(blob: bytes) -> int:
    """blake2b-8 of a blob's bytes, read little-endian (as `digest_u64`)."""
    import hashlib

    return int.from_bytes(hashlib.blake2b(blob, digest_size=8).digest(), "little")


def compressed_gate_client(params, device) -> dict:
    """The client: gates.keygen's stream of draws (two child sources, the LWE
    secret, the GLWE secret) with the seed-compressed BRK and GLWE → LWE key
    in place of the direct ones, each serialized; the seconds of each step."""
    import torch

    from poulpy_tpu_torch.binfhe.blind_rotation import blind_rotation_key_encrypt_sk_compressed
    from poulpy_tpu_torch.core import compressed, encryption
    from poulpy_tpu_torch.core.prepared import glwe_secret_prepare
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.hal.source import Source
    from poulpy_tpu_torch.utils.serialization import serialize_layout

    m = get_module(params.n_glwe, params.nprimes, params.prime_bits, device)
    t0 = time.perf_counter()
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sk_lwe = torch.from_numpy(src.binary_block(params.n_lwe, params.block_size)).to(m.device)
    sk_glwe = encryption.secret_new(m, 1, src)
    skp = glwe_secret_prepare(m, sk_glwe)
    sync(m.device)
    t1 = time.perf_counter()
    brk_c = blind_rotation_key_encrypt_sk_compressed(m, sk_lwe, skp, params.base2k, params.k_brk,
                                                     params.dnum_brk, xe, xa)
    ksk_c = compressed.glwe_to_lwe_key_encrypt_sk_compressed(m, sk_lwe, sk_glwe, params.base2k,
                                                             params.k_ksk, params.dnum_ksk, xe, xa)
    sync(m.device)
    t2 = time.perf_counter()
    brk_blob, ksk_blob = serialize_layout(brk_c), serialize_layout(ksk_c)
    t3 = time.perf_counter()
    return dict(m=m, sk_lwe=sk_lwe, sk_glwe=sk_glwe, skp=skp, brk_blob=brk_blob,
                ksk_blob=ksk_blob, secrets_s=t1 - t0, keygen_s=t2 - t1, serialize_s=t3 - t2)


def compressed_gate_server(params, brk_blob: bytes, ksk_blob: bytes, device) -> tuple:
    """The server: both blobs read onto `device`, the BRK decompressed and
    prepared, the switching key decompressed and prepared, the keygen's LUT.
    Returns (BootstrapKeys, the BRK as read, the seconds of each step)."""
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.binfhe.blind_rotation import (
        BlindRotationKeyCompressed,
        blind_rotation_key_decompress,
    )
    from poulpy_tpu_torch.core.compressed import GGLWECompressed, gglwe_decompress
    from poulpy_tpu_torch.core.prepared import gglwe_prepare
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.utils.serialization import deserialize_layout

    m = get_module(params.n_glwe, params.nprimes, params.prime_bits, device)
    t0 = time.perf_counter()
    brk_c = deserialize_layout(brk_blob, BlindRotationKeyCompressed, m.device)
    ksk_c = deserialize_layout(ksk_blob, GGLWECompressed, m.device)
    sync(m.device)
    t1 = time.perf_counter()
    brk = blind_rotation_key_decompress(m, brk_c)
    sync(m.device)
    t2 = time.perf_counter()
    to_lwe = gglwe_prepare(m, gglwe_decompress(m, ksk_c))
    sync(m.device)
    t3 = time.perf_counter()
    keys = gates.BootstrapKeys(module=m, params=params, brk=brk, to_lwe=to_lwe,
                               lut=gates._sign_lut(params, m.device))
    return keys, brk_c, dict(deserialize_s=t1 - t0, brk_decompress_s=t2 - t1,
                             ksk_decompress_s=t3 - t2)


def compressed_decompress_split(m, ggsw_c) -> tuple:
    """The BRK's decompress again, step by step, the device synchronised
    between steps: the host's ChaCha8 draws (through the native keystream,
    as the decompress draws them), their upload, the GGSW's assembly,
    `vmp_prepare` (its NTT launches and shapes); then the same draw once
    through the plain keystream, which must give the same digits.  Returns
    (the GGSW, its pmats, the seconds and counts)."""
    from unittest import mock

    import numpy as np
    import torch

    from poulpy_tpu_torch import native
    from poulpy_tpu_torch.backends import LAUNCHES, NTT_ROWS
    from poulpy_tpu_torch.core import compressed
    from poulpy_tpu_torch.hal import dft, source

    shape = compressed._ggsw_mask_shape(ggsw_c)
    t0 = time.perf_counter()
    digits = compressed._mask_digits(ggsw_c.seed, ggsw_c.base2k, shape)
    t1 = time.perf_counter()
    mask = torch.from_numpy(digits).to(m.device)
    sync(m.device)
    t2 = time.perf_counter()
    ggsw = compressed._ggsw_assemble(m, ggsw_c, mask)
    del mask
    sync(m.device)
    t3 = time.perf_counter()
    launches, rows = LAUNCHES["ntt_forward"], Counter(NTT_ROWS)
    pmats = dft.vmp_prepare(m, ggsw.data)
    sync(m.device)
    t4 = time.perf_counter()
    ntt_shapes = [[*rows_shape, k] for rows_shape, k in sorted((Counter(NTT_ROWS) - rows).items())]
    with mock.patch.object(native, "chacha8_blocks", source.plain_keystream):
        t5 = time.perf_counter()
        plain = compressed._mask_digits(ggsw_c.seed, ggsw_c.base2k, shape)
        plain_s = time.perf_counter() - t5
    plain_equal = bool(np.array_equal(plain, digits))
    draws, nbytes = digits.size, digits.nbytes
    del plain, digits
    return ggsw, pmats, dict(draws_s=t1 - t0, keystream="native", plain_keystream_draws_s=plain_s,
                             plain_keystream_equal=plain_equal, draws=draws, mask_shape=list(shape),
                             upload_s=t2 - t1, upload_bytes=nbytes,
                             assemble_s=t3 - t2, vmp_prepare_s=t4 - t3,
                             vmp_prepare_ntt_forward=LAUNCHES["ntt_forward"] - launches,
                             vmp_prepare_ntt_shapes=ntt_shapes)


def phase_compressed_noise(params, m, ggsw, sk_lwe, skp) -> None:
    """`ggsw_noise` of the decompressed GGSWs of the LWE coefficients
    NOISE_COEFFS, every row, columns 0 and 1, on the card and in the port's
    CPU run on the same rows: the same Stats; their log2 std beside the
    fresh-encryption level noise.log2_std(noise.var_sigma(3.2, k))."""
    import dataclasses

    import torch

    from poulpy_tpu_torch.core import noise
    from poulpy_tpu_torch.hal.module import get_module

    idx = list(NOISE_COEFFS)
    rows = ggsw.replace(data=ggsw.data[idx])
    pt = torch.zeros((len(idx), m.n), dtype=torch.int64, device=m.device)
    pt[:, 0] = sk_lwe[idx]
    cpu = torch.device("cpu")
    mc = get_module(params.n_glwe, params.nprimes, params.prime_bits, cpu)
    reads, equal = [], True
    for row in range(ggsw.dnum):
        for col in range(2):
            card = noise.ggsw_noise(m, rows, row, col, pt, skp)
            host = noise.ggsw_noise(mc, moved(rows, cpu), row, col, pt.cpu(), moved(skp, cpu))
            equal &= card == host
            reads.append(dict(row=row, col=col, **dataclasses.asdict(card),
                              log2_std=card.log2_std, log2_max=card.log2_max))
    fresh = noise.log2_std(noise.var_sigma(NOISE_SIGMA, ggsw.k))
    emit(phase="compressed_gate_noise", coefficients=idx, k=ggsw.k, fresh_log2_std=fresh,
         card_equals_cpu=bool(equal), reads=reads)
    if not equal:
        raise SystemExit("compressed_gate: the card's ggsw_noise differs from the CPU run's")


def run_compressed_gate_path(device, digest: int | None, fingerprint: int | None,
                             gate_per_nand: dict | None) -> None:
    """The compressed_gate path at the gate path's configuration: the client
    makes and serializes the compressed keys (beside the direct keygen with
    the branched children, which the decompressed keys must equal); the
    server reads them onto the card, decompresses and prepares them; one
    NAND at batch GATE_BATCH on them (truth, fingerprint, block steps per
    NAND equal to the gate path's), then 3 timed; the noise read."""
    import numpy as np
    import torch

    from poulpy_tpu_torch import native
    from poulpy_tpu_torch.backends import LAUNCHES
    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.binfhe.blind_rotation import blind_rotation_key_encrypt_sk
    from poulpy_tpu_torch.core.conversion import glwe_to_lwe_key_encrypt_sk
    from poulpy_tpu_torch.hal.source import Source
    from poulpy_tpu_torch.utils.serialization import serialize_layout

    def peak_gib(reset: bool = True) -> float | None:
        """Peak device memory since the last reset, then reset."""
        if device.type != "cuda":
            return None
        peak = torch.cuda.max_memory_allocated() / 2**30
        if reset:
            torch.cuda.reset_peak_memory_stats()
        return peak

    card = card_label() if device.type == "cuda" else "cpu"
    params = gates.GateParams(n_lwe=GATE_N_LWE, block_size=GATE_BLOCK)
    peak_gib()
    client = compressed_gate_client(params, device)
    m, sk_lwe = client["m"], client["sk_lwe"]
    brk_digest = blob_digest(client["brk_blob"])
    peaks = {"client": peak_gib()}
    keys, brk_c, server = compressed_gate_server(params, client["brk_blob"], client["ksk_blob"],
                                                 device)
    peaks["server"] = peak_gib(reset=False)
    ggsw, pmats, split = compressed_decompress_split(m, brk_c.ggsw)
    full_bytes = len(serialize_layout(ggsw))
    emit(phase="compressed_gate_keys", card=card, host_cpu=native.host_cpu()["model"],
         brk_blob_bytes=len(client["brk_blob"]),
         ksk_blob_bytes=len(client["ksk_blob"]), full_ggsw_blob_bytes=full_bytes,
         brk_blob_digest=brk_digest, brk_blob_digest_expected=digest,
         secrets_s=client["secrets_s"], compressed_keygen_s=client["keygen_s"],
         serialize_s=client["serialize_s"], **server, brk_decompress_split=split)
    checks = {"brk_blob_digest": digest is None or brk_digest == digest,
              "split_equals_decompress": bool(torch.equal(pmats, keys.brk.pmats)),
              "plain_keystream_draw_equal": split["plain_keystream_equal"]}
    del pmats

    # the direct keygen with each branched child in place of xa
    src = Source(bytes(32))
    xe, xa = src.branch()[1], src.branch()[1]
    sync(m.device)
    t0 = time.perf_counter()
    brk = blind_rotation_key_encrypt_sk(m, sk_lwe, client["skp"], params.base2k, params.k_brk,
                                        params.dnum_brk, xe, xa.branch()[1])
    to_lwe = glwe_to_lwe_key_encrypt_sk(m, sk_lwe, client["sk_glwe"], params.base2k,
                                        params.k_ksk, params.dnum_ksk, xe, xa.branch()[1])
    sync(m.device)
    direct_s = time.perf_counter() - t0
    checks["brk_equals_direct"] = bool(torch.equal(keys.brk.pmats, brk.pmats))
    checks["ksk_equals_direct"] = bool(torch.equal(keys.to_lwe.pmat, to_lwe.pmat))
    del brk, to_lwe

    b1 = np.random.default_rng(0).integers(0, 2, GATE_BATCH)
    b2 = np.random.default_rng(1).integers(0, 2, GATE_BATCH)
    xe, xa = Source(b"\x05" * 32), Source(b"\x06" * 32)
    c1 = gates.encrypt_bit(params, b1, sk_lwe, xe, xa)
    c2 = gates.encrypt_bit(params, b2, sk_lwe, xe, xa)
    before = dict(LAUNCHES)
    out = gates.gate_nand(keys, c1, c2)
    value = int((out.data.abs() % 65536).sum())
    per_nand = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    checks["nand_truth"] = bool(np.array_equal(gates.decrypt_bit(out, sk_lwe), 1 - (b1 & b2)))
    checks["fingerprint"] = fingerprint is None or value == fingerprint
    if gate_per_nand is not None:
        checks["block_steps_per_nand_equal_gate_path"] = all(
            per_nand.get(k) == gate_per_nand.get(k) for k in ("br_block_step", "br_block_chain"))
    sync(m.device)
    t0 = time.perf_counter()
    for _ in range(3):
        out = gates.gate_nand(keys, out, c2)
    sync(m.device)
    ms_per_nand = (time.perf_counter() - t0) / 3 * 1e3
    emit(phase="compressed_gate_nand", card=card, batch=GATE_BATCH, fingerprint=value,
         fingerprint_expected=fingerprint, launches_per_nand=per_nand,
         gate_path_launches_per_nand=gate_per_nand, ms_per_nand=ms_per_nand,
         direct_keygen_s=direct_s, compressed_keygen_s=client["keygen_s"],
         brk_kernel_layouts_cached=sorted(map(str, keys.brk.__dict__.get("_pm_kernel", {}))))
    phase_compressed_noise(params, m, ggsw, sk_lwe, client["skp"])
    emit(phase="compressed_gate_checks", card=card, **checks,
         peak_mem_gib_client=peaks["client"], peak_mem_gib_server=peaks["server"],
         peak_mem_gib_after=peak_gib())
    if not all(checks.values()):
        raise SystemExit(f"compressed_gate failed: {checks}")


# the mesh path: the batch of each 2-way local step, held against the CPU
MESH_LOCAL_BATCH, MESH_SHARDED_BATCH, MESH_REPS = 64, 1024, 3


def timed_turns(fns: dict, reps: int, device) -> dict:
    """Milliseconds per call of each of `fns` (name → callable), timed in
    turns a, b, b, a after one untimed call of each (each turn `reps` calls,
    the device synchronised around it), the mean of its two turns."""
    names = list(fns)
    ms = {k: [] for k in names}
    for fn in fns.values():
        fn()
    for name in names + names[::-1]:
        sync(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            fns[name]()
        sync(device)
        ms[name].append((time.perf_counter() - t0) / reps * 1e3)
    return {k: sum(v) / len(v) for k, v in ms.items()}


def full(x):
    """A DTensor gathered whole (at world 1 its one shard); a tensor as it is."""
    from torch.distributed.tensor import DTensor

    return x.full_tensor() if isinstance(x, DTensor) else x


def checksum(data) -> int:
    return int((full(data).abs() % 65536).sum())


def mesh_output(phase: str, data, mesh) -> None:
    """Raise unless `data` is a DTensor on `mesh` placed Shard(0) on dp."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    want = [Shard(0)] + [Replicate()] * (mesh.ndim - 1)
    if not (isinstance(data, DTensor) and data.device_mesh == mesh
            and list(data.placements) == want):
        raise SystemExit(f"{phase}: the output is {type(data).__name__} "
                         f"{getattr(data, 'placements', None)}, not a DTensor placed {want}")


def phase_mesh_dp(mesh, setups: dict, label: str) -> None:
    """The four dp checks through module_with_mesh on the earlier paths'
    set-ups, each reproducing its path's checksum or fingerprint, each timed
    against the mesh-less path in the same run (the cost of the DTensor
    wrap), no collective issued."""
    import torch

    from poulpy_tpu_torch.binfhe import gates
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.hal.module import module_with_mesh
    from poulpy_tpu_torch.parallel import COLLECTIVES, reset_collectives
    from poulpy_tpu_torch.parallel.sharded import sharded_gate_bootstrap_fn

    reset_collectives()
    # product: 1 warm-up + ITERS chained products at B = 16384, in turns
    ct, ggswp = setups["bench"]
    m = get_bench_module(ct.data.device)
    mm = module_with_mesh(m, mesh)
    chains = {}

    def chain(module):
        def run():
            out = glwe_external_product(module, ct, ggswp)
            for _ in range(ITERS):
                out = glwe_external_product(module, out, ggswp)
            chains[module is mm] = out
        return run

    ms = timed_turns({"mesh": chain(mm), "mesh_less": chain(m)}, 1, m.device)
    out = chains[True].data
    mesh_output("mesh_dp_product", out, mesh)
    value = checksum(out)
    emit(phase="mesh_dp_product", card=label, batch=BATCH, iters=ITERS,
         ms_per_iter=ms["mesh"] / (ITERS + 1), mesh_less_ms_per_iter=ms["mesh_less"] / (ITERS + 1),
         wrap_share=ms["mesh"] / ms["mesh_less"] - 1, checksum=value, checksum_expected=CHECKSUM,
         equal_to_mesh_less=bool(torch.equal(full(out), chains[False].data)))
    if value != CHECKSUM:
        raise SystemExit(f"mesh_dp_product: checksum {value} != {CHECKSUM}")
    del chains, out

    # gate: NAND at batch 1024 through sharded_gate_bootstrap_fn
    keys, _, _, _, c1, c2 = setups["gate"][0]
    nand = sharded_gate_bootstrap_fn(keys, mesh, "nand")
    out = nand(c1.data, c2.data)
    mesh_output("mesh_dp_gate", out, mesh)
    value = checksum(out)
    ms = timed_turns({"mesh": lambda: nand(c1.data, c2.data),
                      "mesh_less": lambda: gates.gate_nand(keys, c1, c2)}, MESH_REPS, m.device)
    emit(phase="mesh_dp_gate", card=label, batch=c1.data.shape[0], ms=ms["mesh"],
         mesh_less_ms=ms["mesh_less"], wrap_share=ms["mesh"] / ms["mesh_less"] - 1,
         fingerprint=value, fingerprint_expected=GATE_FINGERPRINT)
    if value != GATE_FINGERPRINT:
        raise SystemExit(f"mesh_dp_gate: fingerprint {value} != {GATE_FINGERPRINT}")

    # CKKS: mul + rescale(5) of the pair broadcast to CKKS_BATCH rows
    cm, _, tsk, _, _, (a, b), _ = setups["ckks"]
    cmm = module_with_mesh(cm, mesh)
    shape = (CKKS_BATCH,) + tuple(a.glwe.data.shape)
    a, b = (c.replace(glwe=c.glwe.replace(data=c.glwe.data.expand(shape).contiguous()))
            for c in (a, b))
    out = ckks_mul(cmm, a, b, tsk, CKKS)
    mesh_output("mesh_dp_ckks", out.glwe.data, mesh)
    data = full(out.glwe.data)
    value = int((data[0].abs() % 65536).sum())
    rows_equal = bool((data == data[:1]).all())
    ms = timed_turns({"mesh": lambda: ckks_mul(cmm, a, b, tsk, CKKS),
                      "mesh_less": lambda: ckks_mul(cm, a, b, tsk, CKKS)}, MESH_REPS, m.device)
    emit(phase="mesh_dp_ckks", card=label, batch=CKKS_BATCH, ms=ms["mesh"],
         mesh_less_ms=ms["mesh_less"], wrap_share=ms["mesh"] / ms["mesh_less"] - 1,
         fingerprint=value, fingerprint_expected=CKKS_FINGERPRINT, rows_equal=rows_equal,
         log_delta=out.meta.log_delta, log_budget=out.meta.log_budget)
    if value != CKKS_FINGERPRINT or not rows_equal:
        raise SystemExit(f"mesh_dp_ckks: fingerprint {value}, rows equal {rows_equal}")

    # CBT: the cbt path's warm-up batch of CBT_BATCH
    s = setups["cbt"]
    bm, key, lwe = s["m"], s["key"], s["lwes"][-1]
    bmm = module_with_mesh(bm, mesh)
    out = cbt(bmm, key, lwe).data
    mesh_output("mesh_dp_cbt", out, mesh)
    value = checksum(out)
    ms = timed_turns({"mesh": lambda: cbt(bmm, key, lwe), "mesh_less": lambda: cbt(bm, key, lwe)},
                     1, m.device)
    emit(phase="mesh_dp_cbt", card=label, batch=CBT_BATCH, ms=ms["mesh"],
         mesh_less_ms=ms["mesh_less"], wrap_share=ms["mesh"] / ms["mesh_less"] - 1,
         fingerprint=value, fingerprint_expected=CBT_FINGERPRINT, collectives=dict(COLLECTIVES))
    if value != CBT_FINGERPRINT or any(COLLECTIVES.values()):
        raise SystemExit(f"mesh_dp_cbt: fingerprint {value}, collectives {COLLECTIVES}")


def get_bench_module(device):
    from poulpy_tpu_torch.hal.module import get_module

    return get_module(N, NPRIMES, PRIME_BITS, device)


def sharded_check(phase: str, label: str, device, run, plain, per_op: dict) -> None:
    """`run()` (a sharded builder's call, returning a DTensor) equal to
    `plain()` (the mesh-less path) with the collectives `per_op` per call,
    each timed in turns; on the card, then, `run` once under the profiler
    (where its device time goes)."""
    import torch

    from poulpy_tpu_torch.parallel import COLLECTIVES, reset_collectives

    reset_collectives()
    have = full(run())
    counts = dict(COLLECTIVES)
    equal = bool(torch.equal(have, plain()))
    ms = timed_turns({"sharded": run, "mesh_less": plain}, MESH_REPS, device)
    emit(phase=phase, card=label, equal_to_mesh_less=equal, collectives_per_op=counts,
         collectives_expected=per_op, ms=ms["sharded"], mesh_less_ms=ms["mesh_less"],
         shape=list(have.shape))
    if not equal or {k: v for k, v in counts.items() if v} != per_op:
        raise SystemExit(f"{phase}: equal {equal}, collectives {counts} (expected {per_op})")
    if device.type == "cuda":
        profile_once(f"{phase}_profile", run, ms["sharded"])


def phase_mesh_sharded(mesh, setups: dict, label: str) -> None:
    """tp 1, sp 1 and kp 1 at world 1 over NCCL: each builder equal to the
    mesh-less path at batch MESH_SHARDED_BATCH, with the collectives the
    JAX package's design issues per op."""
    from poulpy_tpu_torch.binfhe.blind_rotation import blind_rotation_execute_block
    from poulpy_tpu_torch.core.external_product import glwe_external_product
    from poulpy_tpu_torch.parallel.mesh import mesh_from_ranks
    from poulpy_tpu_torch.parallel.sharded import (
        sharded_blind_rotation_block_fn,
        sharded_external_product_fn,
        sharded_external_product_ring_fn,
    )

    ct, ggswp = setups["bench"]
    m = get_bench_module(ct.data.device)
    ct = ct.replace(data=ct.data[:MESH_SHARDED_BATCH])
    res_size = ct.data.shape[-2]

    def product():
        return glwe_external_product(m, ct, ggswp).data

    tp = sharded_external_product_fn(m, mesh, BASE2K, res_size, ggswp.base2k)
    sharded_check("mesh_tp1", label, m.device, lambda: tp(ct.data, ggswp.pmat), product,
                  {"all_gather": 1})
    ring = sharded_external_product_ring_fn(m, mesh_from_ranks(m.device, (1, 1), ("dp", "sp")),
                                            BASE2K, res_size, ggswp.base2k)
    sharded_check("mesh_sp1", label, m.device, lambda: ring(ct.data, ggswp.pmat), product,
                  {"all_to_all": 4})
    keys, _, _, _, c1, _ = setups["gate"][0]
    block = keys.params.block_size
    kp = sharded_blind_rotation_block_fn(keys.module, mesh_from_ranks(m.device, (1, 1),
                                                                      ("dp", "kp")),
                                         keys.lut, keys.brk, block)
    sharded_check("mesh_kp1", label, m.device, lambda: kp(c1),
                  lambda: blind_rotation_execute_block(keys.module, c1, keys.lut, keys.brk, block),
                  {"all_reduce": keys.brk.n_lwe // block})


def phase_mesh_local(setups: dict, label: str) -> None:
    """The rank-local steps of 2-way layouts on the card at full width: for
    tp 2, rank r's residues of its prime before the all_gather; for kp 2,
    rank r's NTT-domain update of the first block step before the
    all_reduce; each equal to the same step on the CPU through the plain
    versions (no collective is emulated)."""
    import torch

    from poulpy_tpu_torch.backends import LAUNCHES, NTT_ROWS
    from poulpy_tpu_torch.hal import dft
    from poulpy_tpu_torch.hal.module import get_module
    from poulpy_tpu_torch.parallel.sharded import (
        kp_block_update,
        kp_members,
        local_module,
        prime_slice,
        tp_local_residues,
    )

    cpu = torch.device("cpu")
    ct, ggswp = setups["bench"]
    m = get_bench_module(ct.data.device)
    mc = get_bench_module(cpu)
    data = ct.data[:MESH_LOCAL_BATCH]
    keys, _, _, _, c1, _ = setups["gate"][0]
    gm, block = keys.module, keys.params.block_size
    gmc = get_module(gm.n, gm.nprimes, keys.params.prime_bits, cpu)
    lwe = c1.replace(data=c1.data[:MESH_LOCAL_BATCH])
    lut_c, brk_c, lwe_c = moved(keys.lut, cpu), moved(keys.brk, cpu), moved(lwe, cpu)
    checks = {}
    before = dict(LAUNCHES)
    for r in range(2):
        lo, hi = prime_slice(m.nprimes, 2, r)
        pm = ggswp.pmat[..., lo:hi, :]
        have = tp_local_residues(local_module(m, lo, hi), data, pm)
        want = tp_local_residues(local_module(mc, lo, hi), data.cpu(), pm.cpu())
        checks[f"tp2_rank{r}"] = bool(torch.equal(have.cpu(), want))
        acc, a_loc, pm_loc = kp_members(gm, lwe, keys.lut, keys.brk, block, 2, r)
        have = kp_block_update(gm, dft.dft_apply(gm, acc), a_loc[0], pm_loc[0])
        acc, a_loc, pm_loc = kp_members(gmc, lwe_c, lut_c, brk_c, block, 2, r)
        want = kp_block_update(gmc, dft.dft_apply(gmc, acc), a_loc[0], pm_loc[0])
        checks[f"kp2_rank{r}"] = bool(torch.equal(have.cpu(), want))
    launches = {k: LAUNCHES[k] - before[k] for k in LAUNCHES if LAUNCHES[k] != before[k]}
    one_prime = sorted([*shape, k] for shape, k in NTT_ROWS.items() if shape[1] == 1)
    emit(phase="mesh_local", card=label, batch=MESH_LOCAL_BATCH, **checks, launches=launches,
         ntt_launches_at_one_prime=one_prime)
    if not all(checks.values()) or (m.device.type == "cuda" and not one_prime):
        raise SystemExit(f"mesh_local: {checks}, NTT launches at P 1: {one_prime}")


def run_mesh_path(setups: dict, device) -> None:
    """The mesh path: one process group in this process (world 1, the rank
    count of one card: NCCL on the card, gloo for a CPU rehearsal; a
    FileStore in a temporary directory), the (dp, tp) mesh over it, then the
    dp checks, the sharded builders at world 1 and the 2-way rank-local
    steps; peak device memory of the phase."""
    import tempfile

    import torch
    import torch.distributed as dist

    from poulpy_tpu_torch.hal.ntt import canonical_device
    from poulpy_tpu_torch.parallel import make_mesh
    from poulpy_tpu_torch.parallel.collectives import BACKENDS

    device = canonical_device(device)
    cuda = device.type == "cuda"
    label = card_label() if cuda else "cpu"
    if cuda:
        torch.cuda.set_device(device)
        torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group(BACKENDS[device.type],
                                store=dist.FileStore(str(Path(tmp) / "store"), 1),
                                world_size=1, rank=0)
        try:
            mesh = make_mesh(device=device)
            emit(phase="mesh_group", card=label, backend=dist.get_backend(),
                 world_size=dist.get_world_size(), mesh=dict(zip(mesh.mesh_dim_names,
                                                                 mesh.shape)),
                 axis_backends={a: dist.get_backend(mesh.get_group(a))
                                for a in mesh.mesh_dim_names})
            phase_mesh_dp(mesh, setups, label)
            phase_mesh_sharded(mesh, setups, label)
            phase_mesh_local(setups, label)
        finally:
            dist.destroy_process_group()
    emit(phase="mesh_memory", card=label,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2**30 if cuda else None)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if not (ROOT / "poulpy_tpu_torch" / "csrc").is_dir():
        print("chip_smoke: the poulpy_tpu_torch package is not beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from poulpy_tpu_torch.backends import (LAUNCHES, NTT_ROWS, _lib, fused, fused_mxu,
                                           reset_launches, wide)
    from poulpy_tpu_torch.hal.module import get_module

    smi = card_label()
    print(smi, flush=True)
    emit(phase="device", nvidia_smi=smi, name=torch.cuda.get_device_name(0),
         torch=torch.__version__, cuda=torch.version.cuda)

    t0 = time.perf_counter()
    _lib.library()
    emit(phase="build", seconds=time.perf_counter() - t0, built=_lib.build_info["built"],
         library=str(Path(_lib.build_info["path"]).relative_to(ROOT)))
    phase_ptxas()
    phase_native()

    m = get_module(N, NPRIMES, PRIME_BITS, "cuda")
    gm = get_module(1024, 2, 28, "cuda")          # GateParams' n_glwe, nprimes, prime_bits
    wm = get_module(CKKS_WIDE.n, CKKS_WIDE.nprimes, 28, "cuda")
    timings = phase_kernels(m, gm, wm)
    torch.cuda.empty_cache()

    shared = {}     # set-ups of the product, keyswitch and ckks paths, for the paths after them

    def on_card(key: str):
        shared[key] = moved(shared[key], m.device)
        return shared[key]

    runs = {
        # the verify set-up waits on the host while the bench runs
        "product": lambda: shared.update(verify=moved(phase_verify(m), torch.device("cpu")),
                                         bench=phase_bench(m)),
        "gate": lambda: shared.update(gate=(gate := run_gate_path(
            m.device, GATE_N_LWE, GATE_BATCH, GATE_VERIFY_BATCH, STD_N_LWE, GATE_ITERS,
            GATE_FINGERPRINT)), gate_per_nand=gate[2]),
        "keyswitch": lambda: shared.update(keyswitch=phase_keyswitch(m.device, KS_N)),
        "ckks_wide": lambda: run_ckks_path("ckks_wide", CKKS_WIDE, m.device, CKKS_BATCH,
                                           CKKS_ITERS, CKKS_WIDE_FINGERPRINT),
        "ckks": lambda: shared.update(ckks=run_ckks_path("ckks", CKKS, m.device, CKKS_BATCH,
                                                         CKKS_ITERS, CKKS_FINGERPRINT)),
        "relinearize": lambda: run_relinearize_path(shared["ckks"], CKKS_BATCH, CKKS_ITERS,
                                                    RELIN_FINGERPRINT),
        "ckks_rotate": lambda: run_rotate_path(shared["ckks"], CKKS_BATCH, CKKS_ITERS,
                                               {"rotate": ROTATE_FINGERPRINT,
                                                "conjugate": CONJUGATE_FINGERPRINT}),
        **{f"product_{route}": lambda route=route: (
            phase_route_verify(m, on_card("verify"), route),
            chain_bench(m, *on_card("bench"), route, f"bench_{route}", profile=True))
           for route in ROUTES},
        **{f"keyswitch_{route}": lambda route=route: phase_keyswitch_route(
            on_card("keyswitch"), route) for route in ROUTES},
        "gate_fused_mxu": lambda: run_gate_route_path(on_card("gate"), GATE_VERIFY_BATCH,
                                                      STD_N_LWE, GATE_ITERS, GATE_FINGERPRINT,
                                                      "fused_mxu"),
        "cbt": lambda: shared.update(cbt=run_cbt_path("cbt", CBT_N_LWE, 1, m.device,
                                                      CBT_FINGERPRINT, False)),
        "cbt_block8": lambda: shared.update(cbt_block8=run_cbt_path(
            "cbt_block8", CBT_BLOCK8_N_LWE, CBT_BLOCK, m.device, CBT_BLOCK8_FINGERPRINT, True)),
        "fheuint_add": lambda: shared.update(bdd=run_fheuint_add_path(m.device,
                                                                      FHEUINT_ADD_FINGERPRINT)),
        "blind_retrieval": lambda: run_blind_retrieval_path(shared["bdd"]),
        "compressed_gate": lambda: run_compressed_gate_path(
            m.device, COMPRESSED_BRK_BLOB_DIGEST, COMPRESSED_GATE_FINGERPRINT,
            shared["gate_per_nand"]),
        "cbt_fused_mxu": lambda: run_cbt_route_path("cbt_fused_mxu", on_card("cbt"), "fused_mxu",
                                                    CBT_FINGERPRINT),
        "cbt_block8_fused_mxu": lambda: run_cbt_route_path(
            "cbt_block8_fused_mxu", on_card("cbt_block8"), "fused_mxu", CBT_BLOCK8_FINGERPRINT),
        "cbt_mxu": lambda: run_cbt_route_path("cbt_mxu", on_card("cbt"), "mxu", CBT_FINGERPRINT),
        "fheuint_add_fused_mxu": lambda: run_fheuint_route_path(on_card("bdd"), "fused_mxu",
                                                                FHEUINT_ADD_FINGERPRINT),
        "routes": lambda: run_routes_path(on_card("bdd"), on_card("ckks")),
        "examples": lambda: run_examples_path(m.device),
        "mesh": lambda: run_mesh_path({key: on_card(key)
                                       for key in ("bench", "gate", "ckks", "cbt")}, m.device),
    }
    # after each path: the set-ups it parks on the host until the MXU paths,
    # and those it leaves behind for the last time
    park = {"product": ("bench",), "gate": ("gate",), "keyswitch": ("keyswitch",),
            "ckks_rotate": ("ckks",), f"product_{ROUTES[-1]}": ("bench",),
            "gate_fused_mxu": ("gate",), "cbt": ("cbt",), "cbt_block8": ("cbt_block8",),
            "blind_retrieval": ("bdd",), "cbt_fused_mxu": ("cbt",), "cbt_mxu": ("cbt",),
            "fheuint_add_fused_mxu": ("bdd",), "routes": ("ckks",)}
    last_use = {f"product_{ROUTES[-1]}": ("verify",),
                f"keyswitch_{ROUTES[-1]}": ("keyswitch",), "cbt_block8_fused_mxu": ("cbt_block8",),
                "routes": ("bdd",), "mesh": ("bench", "gate", "ckks", "cbt")}
    launches = dict.fromkeys(LAUNCHES, 0)
    ntt_rows = Counter()
    for path, run in runs.items():
        reset_launches()
        run()
        counts = dict(LAUNCHES)
        emit(phase="launches", path=path, **counts)
        if NTT_ROWS:
            emit(phase="ntt_shapes", path=path, launches=[
                [*shape, k] for shape, k in sorted(NTT_ROWS.items())])
        ntt_rows.update(NTT_ROWS)
        missing = [k for k in PATHS[path] if counts[k] == 0]
        if missing:
            raise SystemExit(f"the {path} path never launched: {missing}")
        stray = [k for k in MXU_KERNELS
                 if counts[k] and not (path.endswith("mxu") or path in MXU_PATHS)]
        if stray:
            raise SystemExit(f"the {path} path launched the MXU route's {stray}")
        for k, v in counts.items():
            launches[k] += v
        for key in park.get(path, ()):
            shared[key] = moved(shared[key], torch.device("cpu"))
        for key in last_use.get(path, ()):
            del shared[key]
        torch.cuda.empty_cache()
    km = get_module(KS_N, 2, device="cuda")       # the keyswitch path's basis (30-bit primes)
    timings.update(phase_kernels_mxu(m, km, gm))
    phase_stages(fused_mxu, fused_mxu_cases(m, km, gm), DESIGNS)
    phase_stages(fused, butterfly_cases(m, km, gm), BUTTERFLY_DESIGNS)
    phase_stages(fused, cbt_stage_cases(gm), CBT_DESIGNS)
    phase_transform_stages(transform_cases(m, km), TRANSFORM_DESIGNS)
    phase_tensor_stages(tensor_cases(m, wm))
    phase_tensor_stages(wide_product_cases(wm), wide.WIDE_STAGES, None)
    phase_kernels_large_n()
    if not all(launches.values()):
        raise SystemExit(f"kernels never launched: {[k for k, v in launches.items() if not v]}")
    phase_ntt_shapes(ntt_rows)

    print(json.dumps({"kernels": [
        dict(name=name, route="cuda", source=src, replaces=rep, launches=launches[name],
             **timings[name])
        for name, (src, rep) in KERNELS.items()
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
