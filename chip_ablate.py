"""Ablate the kernels B1, B2, B3 and B4 of rain_tpu_torch on one card.

Run from the repository root, with one CUDA card:

    python3 chip_ablate.py [--parent DIR] [--b2-step FILE] [--out RECORD.json]

Builds, beside the kernels of rain_tpu_torch/csrc, copies of expand.cu
(B1), reduce.cu (B2), tile_render_fwd.cu (B3) and tile_render_bwd.cu (B4)
with one design element taken out each: an exact text edit of the source,
listed in VARIANTS, that fails if the text is not found. With --parent DIR
it also builds expand.cu and reduce.cu from DIR/rain_tpu_torch/csrc, a
checkout of an earlier commit, and times binning.tile_sort beside a
three-pass version (a gather, a zero pad, a concatenation). It takes the
inputs that B1–B4 get in training step 0 of chip_smoke.py's main path (the
262k garden proxy at 1297x840), holds every variant's output to the plain
version bit for bit (a few B4 variants sum in another order and are held
to 1e-5 of each row's largest value), and times all variants in turns on
the same inputs: the median over REPS rounds of CUDA events around one
call behind a spin kernel, as chip_smoke.device_ms does. With --b2-step
FILE (the b2_trainer_step.npz that chip_smoke.py --out writes: the tiles
and M of B2's input at its Trainer step) it holds and times the B2
variants again at those segments, on seeded random gradient columns. It
prints the card's nvidia-smi line, each variant's ptxas line, resident
blocks per SM and time, one JSON line per kernel and, last, {"ok": true};
--out writes the record.
"""

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as smoke
from rain_tpu_torch import _build
from rain_tpu_torch.model import adam as adam_mod
from rain_tpu_torch.model import gaussians as gmod
from rain_tpu_torch.ops import binning
from rain_tpu_torch.ops import expand as expand_ops
from rain_tpu_torch.ops import tile_render

REPS = 30
ABLATE_DIR = _build.BUILD_DIR / "ablate"

# B4's walk in two passes: A1 evaluates the pairs and keeps e^power and a
# mask of those that composite, A2 runs the recurrence over each lane's
# own set bits, so no lane waits for a neighbour's division
_WALK_HEAD = """\
    while (list != 0u) {
      const int j = __ffs(list) - 1;
      list &= list - 1u;
      bool active = false;
      if (base + j < last) {
        const float4 q0 = reinterpret_cast<const float4*>(s_rec[j])[0];
        const float4 q1 = reinterpret_cast<const float4*>(s_rec[j])[1];
        const float dx = q0.x - px;
        const float dy = q0.y - py;
        const float power = -0.5f * (q0.z * dx * dx + q1.x * dy * dy) -
                            q0.w * dx * dy;
        if (power <= 0.0f) {
          const float G = expf(power);
"""
_SPLIT_WALK = "    unsigned act = 0u;\n" + _WALK_HEAD + """\
          if (fminf(q1.y * G, alpha_clamp) >= alpha_min) {
            active = true;
            act |= 1u << j;
            s_gd[j * kStride + tid] = G;
          }
        }
      }
      const unsigned ballot = __ballot_sync(kFull, active);
      if (lane == 0) s_ballot[j][warp] = ballot;
    }
    // phase A2: the transmittance and dL/dalpha, front to back over this
    // pixel's composited pairs only
    while (act != 0u) {
      const int j = __ffs(act) - 1;
      act &= act - 1u;
      const float G = s_gd[j * kStride + tid];
      const float alpha = fminf(s_rec[j][5] * G, alpha_clamp);
      const float4 q2 = reinterpret_cast<const float4*>(s_rec[j])[2];
"""
_ONE_PASS = _WALK_HEAD + """\
          const float alpha = fminf(q1.y * G, alpha_clamp);
          if (alpha >= alpha_min) {
            active = true;
            const float4 q2 = reinterpret_cast<const float4*>(s_rec[j])[2];
"""
_ONE_PASS_END = ("""\
      s_gd[j * kStride + tid] = dalpha * G;
      s_w[j * kStride + tid] = w;
    }
""", """\
            s_gd[j * kStride + tid] = dalpha * G;
            s_w[j * kStride + tid] = w;
          }
        }
      }
      const unsigned ballot = __ballot_sync(kFull, active);
      if (lane == 0) s_ballot[j][warp] = ballot;
    }
""")
_BWD_DERIVE = """\
      q[7] = __uint_as_float(rain_cull::block_mask(
          q[2], q[3], q[4], q[0], q[1],
          rain_cull::power_floor(q[5], alpha_min), tx0, ty0));
"""
_BWD_LOAD = """\
      for (int r = 0; r < kRows; ++r)
        q[kSlot[r]] = pack[r * m + start + base + tid];
"""
_GATHER = """\
      unsigned sel = 0u;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) {
        const unsigned bits = (s_ballot[j_b][g] >> s_b) & 0x01010101u;
        sel |= ((bits * 0x10204080u) >> 28) << (4 * g);
      }
"""
# the same bits, gathered one at a time (any kSplit)
_LOOP_GATHER = """\
      unsigned sel = 0u;
#pragma unroll
      for (int g = 0; g < kWarps; ++g) {
        const unsigned bits = s_ballot[j_b][g] >> s_b;
#pragma unroll
        for (int u = 0; u < 32 / kSplit; ++u)
          sel |= ((bits >> (kSplit * u)) & 1u) << (g * (32 / kSplit) + u);
      }
"""
_FWD_REACH = """\
      const bool reach =
          k + lane < cnt &&
          ((__float_as_uint(rec[3 * (k + lane) + 1].w) >> warp) & 1u);
"""
# composite_cull.cuh with warp w on the 16x2 strip of rows 2w, 2w + 1 (the
# pixel of thread tid is tid) instead of an 8x4 block
_STRIPS = [
    ("  const int w = tid >> 5, lane = tid & 31;\n"
     "  return 16 * (4 * (w >> 1) + (lane >> 3)) + 8 * (w & 1) + "
     "(lane & 7);\n", "  return tid;\n"),
    ("    const float x0 = (float)(tx0 + 8 * (w & 1));\n"
     "    const float y0 = (float)(ty0 + 4 * (w >> 1));\n"
     "    if (xg + rx >= x0 && xg - rx <= x0 + 7.0f && yg + ry >= y0 &&\n"
     "        yg - ry <= y0 + 3.0f)\n",
     "    const float x0 = (float)tx0;\n"
     "    const float y0 = (float)(ty0 + 2 * w);\n"
     "    if (xg + rx >= x0 && xg - rx <= x0 + 15.0f && yg + ry >= y0 &&\n"
     "        yg - ry <= y0 + 1.0f)\n"),
]

_B1_WARP_LOOP = """\
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool above = p >= hi || offs[p] > target;
    const unsigned ballot = __ballot_sync(kFull, above);
    if (ballot == 0u) {
      lo += 31 * step + 1;
    } else {
      const int j = __ffs(ballot) - 1;
      hi = lo + j * step < hi ? lo + j * step : hi;
      if (j > 0) lo += (j - 1) * step + 1;
    }
  }
"""
_B1_COUNT = """\
  if (tid == 64) s_total = n > 0 ? offs[n - 1] : 0;
  int owner = 0;
  if (warp < 2) owner = warp_owner(offs, n, warp == 0 ? i0 : end - 1, lane);
"""
_B1_WINDOW_SEARCH = """\
            int s = 0, e = len - 1;  // first j with offs[j] > i
            while (s < e) {
              const int mid = (s + e) >> 1;
              if (w.offs[mid] > i) {
                e = mid;
              } else {
                s = mid + 1;
              }
            }
            j = s;
"""
_B1_VEC = """\
  const bool vec_rows = m % 4 == 0 && (uintptr_t)out % 16 == 0;
  const bool vec_keys = (uintptr_t)keys % 16 == 0;
"""
_B1_WINDOW_BLOCK = """\
    const int64_t c_end = c0 + kV < live ? c0 + kV : live;
    int64_t lo = i0;  // instances below lo belong to earlier pieces
    for (int64_t a = g0; a <= g1; a += kWindow) {
      const int len = (int)(g1 - a + 1 < kWindow ? g1 - a + 1 : kWindow);
      if (a != g0) __syncthreads();  // the previous piece is read
      for (int j = tid; j < len; j += kThreads) {
        __pipeline_memcpy_async(&w.offs[j], offs + a + j, 8);
        __pipeline_memcpy_async(&w.tiles[j], tiles + a + j, 4);
        __pipeline_memcpy_async(&w.rect_w[j], rect_w + a + j, 4);
        __pipeline_memcpy_async(&w.rect_base[j], rect_base + a + j, 4);
      }
      __pipeline_commit();
      __pipeline_wait_prior(0);
      __syncthreads();
      const int64_t hi = w.offs[len - 1];  // this piece owns [lo, hi)
      int j = -1;
      Index dx = 0, dy = 0, wd = 1;
#pragma unroll
      for (int v = 0; v < kV; ++v) {
        const int64_t i = c0 + v;
        if (i >= lo && i < hi && i < c_end) {
          if (j < 0) {
            int s = 0, e = len - 1;  // first j with offs[j] > i
            while (s < e) {
              const int mid = (s + e) >> 1;
              if (w.offs[mid] > i) {
                e = mid;
              } else {
                s = mid + 1;
              }
            }
            j = s;
            const Index local = (Index)(i - (w.offs[j] - w.tiles[j]));
            wd = max(w.rect_w[j], 1);
            dy = local / wd;
            dx = local - dy * wd;
          } else if (w.offs[j] > i) {  // the same owner: the next tile
            if (++dx == wd) {
              dx = 0;
              ++dy;
            }
          } else {  // the next owner with a tile starts at its first tile
            do {
              ++j;
            } while (w.offs[j] <= i);
            wd = max(w.rect_w[j], 1);
            dx = 0;
            dy = 0;
          }
          const int64_t tile = (int64_t)w.rect_base[j] + (int64_t)dy * grid_x +
                               dx - tile_offset;
          g[v] = (int)(a + j);
          key[v] = (int64_t)((uint64_t)tile << 32) | g[v];
        }
      }
      lo = hi;
    }
  }

"""
_B1_GLOBAL_WALK = """\
    const int64_t c_end = c0 + kV < live ? c0 + kV : live;
    int j = -1;
    Index dx = 0, dy = 0, wd = 1;
#pragma unroll
    for (int v = 0; v < kV; ++v) {
      const int64_t i = c0 + v;
      if (i < c_end) {
        if (j < 0) {
          int s = g0, e = g1;  // first j with offs[j] > i
          while (s < e) {
            const int mid = s + ((e - s) >> 1);
            if (offs[mid] > i) {
              e = mid;
            } else {
              s = mid + 1;
            }
          }
          j = s;
          const Index local = (Index)(i - (offs[j] - tiles[j]));
          wd = max(rect_w[j], 1);
          dy = local / wd;
          dx = local - dy * wd;
        } else if (offs[j] > i) {
          if (++dx == wd) {
            dx = 0;
            ++dy;
          }
        } else {
          do {
            ++j;
          } while (offs[j] <= i);
          wd = max(rect_w[j], 1);
          dx = 0;
          dy = 0;
        }
        const int64_t tile = (int64_t)rect_base[j] + (int64_t)dy * grid_x +
                             dx - tile_offset;
        g[v] = j;
        key[v] = (int64_t)((uint64_t)tile << 32) | g[v];
      }
    }
  }

"""

_B2_WARP_LOOP = """\
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t p = lo + lane * step;
    const bool above = p >= hi || exc[p] >= target;
    const unsigned ballot = __ballot_sync(kFull, above);
    if (ballot == 0u) {
      lo += 31 * step + 1;
    } else {
      const int j = __ffs(ballot) - 1;
      hi = lo + j * step < hi ? lo + j * step : hi;
      if (j > 0) lo += (j - 1) * step + 1;
    }
  }
"""

# (variant, source, [(text, replacement), ...]); "full" is the source as
# is. B3's heavy-first variant takes a tile order (the tiles by descending
# range length); B4's 16-instance chunk sums 16 partial sums.
VARIANTS = [
    ("b1_full", "expand", []),
    # the block's two owners by a plain binary search (18 dependent loads
    # for 262k Gaussians), not by the warp's ballots
    ("b1_serial_block_search", "expand", [
        (_B1_WARP_LOOP,
         "  while (lo < hi) {\n"
         "    const int64_t mid = (lo + hi) >> 1;\n"
         "    if (offs[mid] > target) {\n"
         "      hi = mid;\n"
         "    } else {\n"
         "      lo = mid + 1;\n"
         "    }\n"
         "  }\n")]),
    # the search waits for the instance count
    ("b1_search_after_count", "expand", [
        (_B1_COUNT,
         "  if (tid == 64) s_total = n > 0 ? offs[n - 1] : 0;\n"
         "  __syncthreads();\n"
         "  int owner = 0;\n"
         "  if (warp < 2 && i0 < s_total)\n"
         "    owner = warp_owner(offs, n, warp == 0 ? i0 : end - 1, lane);\n"
         )]),
    # every thread reads the instance count (the same word in every block)
    ("b1_count_per_thread", "expand", [
        ("  if (tid == 64) s_total = n > 0 ? offs[n - 1] : 0;\n",
         "  const int64_t total = n > 0 ? offs[n - 1] : 0;\n"),
        ("  const int64_t total = s_total;\n", "")]),
    # each thread's first owner by its own binary search over the global
    # offsets, not over the staged window
    ("b1_thread_global_search", "expand", [
        (_B1_WINDOW_SEARCH,
         "            int64_t s = 0, e = n - 1;\n"
         "            while (s < e) {\n"
         "              const int64_t mid = (s + e) >> 1;\n"
         "              if (offs[mid] > i) {\n"
         "                e = mid;\n"
         "              } else {\n"
         "                s = mid + 1;\n"
         "              }\n"
         "            }\n"
         "            j = (int)(s - a);\n")]),
    ("b1_scalar_stores", "expand", [
        (_B1_VEC, "  const bool vec_rows = false;\n"
                  "  const bool vec_keys = false;\n")]),
    ("b1_int64_index", "expand", [
        ("using Index = int32_t;", "using Index = int64_t;")]),
    ("b1_v1", "expand", [
        ("constexpr int kV = 4;", "constexpr int kV = 1;")]),
    ("b1_v8", "expand", [
        ("constexpr int kV = 4;", "constexpr int kV = 8;")]),
    # one wave with twice or half the block: 2048-instance chunks over
    # 2048-Gaussian windows, 3 blocks per SM; 512 over 512, 12 per SM
    ("b1_512_threads", "expand", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 512;"),
        ("constexpr int kWindow = 1024;", "constexpr int kWindow = 2048;"),
        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 3;")]),
    ("b1_128_threads", "expand", [
        ("constexpr int kThreads = 256;", "constexpr int kThreads = 128;"),
        ("constexpr int kWindow = 1024;", "constexpr int kWindow = 512;"),
        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 12;")]),
    # no staged window: each thread searches its first owner between the
    # block's two owners in global memory (L1) and walks on there
    ("b1_no_window", "expand", [
        (_B1_WINDOW_BLOCK, _B1_GLOBAL_WALK),
        ("constexpr int kSmem = (int)sizeof(Window);",
         "constexpr int kSmem = 0;")]),
    # no minimum of resident blocks for the register allocator
    ("b1_no_min_blocks", "expand", [
        ("constexpr int kMinBlocks = 6;", "constexpr int kMinBlocks = 1;")]),
    ("b2_full", "reduce", []),
    # the chunk's owners by a plain binary search (20 dependent loads for
    # 786k Gaussians), not by the warp's ballots
    ("b2_serial_search", "reduce", [
        (_B2_WARP_LOOP,
         "  while (lo < hi) {\n"
         "    const int64_t mid = (lo + hi) >> 1;\n"
         "    if (exc[mid] >= target) {\n"
         "      hi = mid;\n"
         "    } else {\n"
         "      lo = mid + 1;\n"
         "    }\n"
         "  }\n")]),
    # the chunk staged by the whole block once the search is done, not by
    # six warps while two search
    ("b2_search_then_stage", "reduce", [
        ("  if (warp >= 2)\n"
         "    copy_rows<R>(sd, d, rows, m, i0, (int)(lmin(chunk_end, live) - "
         "i0), vec,\n                 tid - 64, kThreads - 64);\n",
         "  __syncthreads();\n"
         "  copy_rows<R>(sd, d, rows, m, i0, (int)(lmin(chunk_end, live) - "
         "i0), vec,\n               tid, kThreads);\n")]),
    ("b2_scalar_copies", "reduce", [
        ("  const bool vec = m % 4 == 0 && (uintptr_t)d % 16 == 0;\n",
         "  const bool vec = false;\n")]),
    # the carried segment read by its row threads from global memory, not
    # staged by the block
    ("b2_global_carry", "reduce", [
        ("    __syncthreads();  // the previous piece is read\n"
         "    copy_rows<R>(sd, d, rows, m, p, len, vec, tid, kThreads);\n"
         "    __pipeline_commit();\n"
         "    __pipeline_wait_prior(0);\n"
         "    __syncthreads();\n"
         "    if (tid < rows) {\n"
         "      const float* row = sd + tid * kChunk;\n",
         "    if (tid < rows) {\n"
         "      const float* row = d + tid * m + p;\n")]),
    ("b2_chunk_512", "reduce", [
        ("constexpr int kChunk = 1024;", "constexpr int kChunk = 512;")]),
    ("b2_chunk_2048", "reduce", [
        ("constexpr int kChunk = 1024;", "constexpr int kChunk = 2048;")]),
    # the 16-byte copies around L1 (cp.async.cg, as
    # __pipeline_memcpy_async issues them), not through it
    ("b2_copies_16_cg", "reduce", [
        ("  asm volatile(\"cp.async.ca.shared.global [%0], [%1], 16;\\n\" "
         "::\"r\"(\n"
         "                   (unsigned)__cvta_generic_to_shared(dst)),\n"
         "               \"l\"(src)\n"
         "               : \"memory\");\n",
         "  __pipeline_memcpy_async(dst, src, 16);\n")]),
    # the searching warps wait for the instance count, so that a chunk
    # past the live instances stops at once, not after its search
    ("b2_exit_before_search", "reduce", [
        ("  if (warp < 2) {\n    const int64_t g =\n",
         "  if (warp < 2 && i0 < live) {\n    const int64_t g =\n")]),
    # the tail blocks first in the grid, not after the chunk blocks
    ("b2_tail_first", "reduce", [
        ("  if (blockIdx.x >= n_chunks) {  // 5. a tail block\n"
         "    const int64_t t0 = (blockIdx.x - n_chunks) * (int64_t)kTail;\n",
         "  const int64_t n_tail = gridDim.x - n_chunks;\n"
         "  if (blockIdx.x < n_tail) {  // 5. a tail block\n"
         "    const int64_t t0 = blockIdx.x * (int64_t)kTail;\n"),
        ("  const int64_t i0 = (int64_t)blockIdx.x * kChunk;\n",
         "  const int64_t i0 = (int64_t)(blockIdx.x - n_tail) * kChunk;\n")]),
    # a short carried rest staged like a long one, not read from global
    # memory by the row threads
    ("b2_always_staged_carry", "reduce", [
        ("  if (c_end - chunk_end <= kShortCarry) {\n",
         "  if (false) {\n")]),
    ("b2_no_min_blocks", "reduce", [
        ("constexpr int kMinBlocks = 5;", "constexpr int kMinBlocks = 1;")]),
    ("b2_min_blocks_4", "reduce", [
        ("constexpr int kMinBlocks = 5;", "constexpr int kMinBlocks = 4;")]),
    ("b2_min_blocks_6", "reduce", [
        ("constexpr int kMinBlocks = 5;", "constexpr int kMinBlocks = 6;")]),
    ("fwd_full", "tile_render_fwd", []),
    ("fwd_no_skip", "tile_render_fwd", [
        ("        if (power < q1.z) continue;\n", "")]),
    ("fwd_no_cull", "tile_render_fwd", [
        (_FWD_REACH, "      const bool reach = k + lane < cnt;\n")]),
    ("fwd_no_instance_list", "tile_render_fwd", [
        ("    for (int k = 0; k < cnt; k += 32) {\n" + _FWD_REACH +
         "      unsigned list = __ballot_sync(kFull, reach);\n"
         "      while (list != 0u && !done) {\n"
         "        const int j = k + __ffs(list) - 1;\n"
         "        list &= list - 1u;\n"
         "        const float4 q0 = rec[3 * j];\n"
         "        const float4 q1 = rec[3 * j + 1];\n",
         "    {\n"
         "      for (int j = 0; j < cnt && !done; ++j) {\n"
         "        const float4 q1 = rec[3 * j + 1];\n"
         "        if (!((__float_as_uint(q1.w) >> warp) & 1u)) continue;\n"
         "        const float4 q0 = rec[3 * j];\n")]),
    ("fwd_strips", "tile_render_fwd", []),
    ("fwd_no_prefetch", "tile_render_fwd", [
        ("  fetch(s[0], pack, m, (int64_t)start + tid, end, tid);\n"
         "  __pipeline_commit();\n", ""),
        ("    fetch(s[buf ^ 1], pack, m, (int64_t)base + kPix + tid, end, "
         "tid);\n    __pipeline_commit();\n    __pipeline_wait_prior(1);\n",
         "    fetch(s[buf], pack, m, (int64_t)base + tid, end, tid);\n"
         "    __pipeline_commit();\n    __pipeline_wait_prior(0);\n")]),
    ("fwd_heavy_first", "tile_render_fwd", [
        ("    int toff, int grid_x, float* __restrict__ out) {",
         "    const int32_t* __restrict__ order, int toff, int grid_x,\n"
         "    float* __restrict__ out) {"),
        ("  const int t = blockIdx.x;", "  const int t = order[blockIdx.x];"),
        ("                                      int n_tiles, int toff, "
         "int grid_x,\n",
         "                                      const void* order, "
         "int n_tiles, int toff, int grid_x,\n"),
        ("      toff, grid_x, (float*)out);",
         "      (const int32_t*)order, toff, grid_x, (float*)out);")]),
    ("bwd_full", "tile_render_bwd", []),
    ("bwd_split_walk", "tile_render_bwd", [
        (_ONE_PASS, _SPLIT_WALK), (_ONE_PASS_END[1], _ONE_PASS_END[0])]),
    ("bwd_warp_end", "tile_render_bwd", [
        ("        lane < cnt && ((__float_as_uint(s_rec[lane][7]) >> warp) & "
         "1u);\n",
         "        lane < min(cnt, wl - base) &&\n"
         "        ((__float_as_uint(s_rec[lane][7]) >> warp) & 1u);\n")]),
    ("bwd_no_cull", "tile_render_bwd", [
        (_BWD_DERIVE, ""),
        ("    const bool reach =\n"
         "        lane < cnt && ((__float_as_uint(s_rec[lane][7]) >> warp) & "
         "1u);\n", "    const bool reach = lane < cnt;\n")]),
    ("bwd_strips", "tile_render_bwd", []),
    ("bwd_no_bit_iteration", "tile_render_bwd", [
        ("      while (sel != 0u) {\n"
         "        const int th = s_b + kSplit * (__ffs(sel) - 1);\n"
         "        sel &= sel - 1u;\n",
         "      for (int i = 0; i < kPix / kSplit; ++i) {\n"
         "        if (!((sel >> i) & 1u)) continue;\n"
         "        const int th = s_b + kSplit * i;\n")]),
    ("bwd_loop_gather", "tile_render_bwd", [(_GATHER, _LOOP_GATHER)]),
    ("bwd_direct_terms", "tile_render_bwd", [
        ("        const float ex = dpow * dx, ey = dpow * dy;\n"
         "        acc[kMx] = acc[kMx] + ex;\n"
         "        acc[kMy] = acc[kMy] + ey;\n"
         "        acc[kMxx] = acc[kMxx] + ex * dx;\n"
         "        acc[kMyy] = acc[kMyy] + ey * dy;\n"
         "        acc[kMxy] = acc[kMxy] + ex * dy;\n",
         "        const float hx = dx * dx, hy = dy * dy, hxy = dx * dy;\n"
         "        acc[0] = acc[0] + -0.5f * dpow * hx;\n"
         "        acc[1] = acc[1] + -dpow * hxy;\n"
         "        acc[2] = acc[2] + -0.5f * dpow * hy;\n"
         "        acc[3] = acc[3] + -dpow * (s_rec[j_b][2] * dx + "
         "s_rec[j_b][3] * dy);\n"
         "        acc[4] = acc[4] + -dpow * (s_rec[j_b][4] * dy + "
         "s_rec[j_b][3] * dx);\n"),
        ("      for (int q = kOp; q < kRows; ++q) s_sum[q][j_b] = acc[q];\n",
         "      for (int q = 0; q < kRows; ++q) s_sum[q][j_b] = acc[q];\n")]),
    ("bwd_with_skip", "tile_render_bwd", [
        (_BWD_DERIVE, "      q[6] = rain_cull::power_floor(q[5], alpha_min);\n"
                      "      q[7] = __uint_as_float(rain_cull::block_mask(\n"
                      "          q[2], q[3], q[4], q[0], q[1], q[6], tx0, "
                      "ty0));\n"),
        ("        if (power <= 0.0f) {\n",
         "        if (power <= 0.0f && !(power < q1.z)) {\n")]),
    ("bwd_with_prefetch", "tile_render_bwd", [
        ("  for (int base = 0; base < n_walk; base += kChunk) {\n",
         "  float nxt[kRows];\n"
         "  if (tid < min(kChunk, n_walk)) {\n"
         "    for (int r = 0; r < kRows; ++r) nxt[r] = pack[r * m + start + "
         "tid];\n  }\n"
         "  for (int base = 0; base < n_walk; base += kChunk) {\n"),
        (_BWD_LOAD, "      for (int r = 0; r < kRows; ++r) q[kSlot[r]] = "
                    "nxt[r];\n"),
        ("tx0, ty0));\n    }\n    __syncthreads();\n",
         "tx0, ty0));\n    }\n"
         "    if (tid < min(kChunk, n_walk - base - kChunk)) {\n"
         "      for (int r = 0; r < kRows; ++r)\n"
         "        nxt[r] = pack[r * m + start + base + kChunk + tid];\n"
         "    }\n    __syncthreads();\n")]),
    ("bwd_chunk16", "tile_render_bwd", [
        ("constexpr int kChunk = 32;", "constexpr int kChunk = 16;"),
        ("static_assert(kSplit == 8, ", "static_assert(kSplit == 16, "),
        (_GATHER, _LOOP_GATHER)]),
]
# edits of composite_cull.cuh, per variant
HEADER_EDITS = {"fwd_strips": _STRIPS, "bwd_strips": _STRIPS}
# variants that sum other terms, or in another order, than the plain
# version: held to 1e-5 of each row's largest value, not bit for bit
REORDERED = {"bwd_direct_terms", "bwd_chunk16", "bwd_strips"}
OCCUPANCY = {"b1": "rain_expand_occupancy",
             "b2": "rain_reduce_occupancy",
             "fwd": "rain_composite_forward_occupancy",
             "bwd": "rain_composite_backward_occupancy"}


def tile_sort_3pass(cols, keys, need_depth=True):
    """binning.tile_sort before it gathered into the pack in one pass: a
    [10, M] gather, a [6, M] zero pad and a concatenation."""
    perm = torch.sort(keys).indices
    rows = cols[:, perm]
    if not need_depth:
        rows[tile_render.ROW_DEPTH] = 0.0
    pad = torch.zeros((tile_render.PACK_ROWS - rows.shape[0], rows.shape[1]),
                      device=rows.device)
    return torch.cat([rows, pad], dim=0), perm


def tile_order(starts, ends):
    """The tiles by descending range length (ties in tile order), int32."""
    return torch.sort(ends - starts, descending=True,
                      stable=True).indices.to(torch.int32)


def build(jobs):
    """Compile {name: (source text, include dir)} with the package's nvcc
    flags, all at once; returns {name: (CDLL, ptxas lines)}."""
    ABLATE_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {}
    for name, (text, include) in jobs.items():
        src = ABLATE_DIR / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(include), "-o",
             str(ABLATE_DIR / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    out = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        out[name] = (ctypes.CDLL(str(ABLATE_DIR / f"{name}.so")),
                     [line.strip() for line in log.splitlines()
                      if "registers" in line or "spill" in line])
    return out


def variant_text(source, edits, suffix=".cu"):
    text = (_build.CSRC / f"{source}{suffix}").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise AssertionError(f"{source}: edit text not found once: "
                                 f"{old!r}")
        text = text.replace(old, new)
    return text


def entry(lib, name, argtypes):
    f = getattr(lib, name)
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, *argtypes]
    f.restype = ctypes.c_int
    return f


def blocks_per_sm(lib, name):
    f = getattr(lib, name, None)
    if f is None:
        return None
    blocks = ctypes.c_int(0)
    f.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    f.restype = ctypes.c_int
    if f(smoke.DEV.index or 0, None, ctypes.addressof(blocks)) != 0:
        raise RuntimeError(f"{name} failed")
    return blocks.value


def step0_inputs():
    """B1's (args, kwargs), B3's, B4's and B2's inputs in training step 0
    of chip_smoke's main path."""
    arrays = smoke.garden_proxy_state_arrays()
    state = gmod.from_arrays(**arrays, device=smoke.DEV)
    cam = smoke.pose(0).render_inputs()
    gt, _ = smoke.render_frame(state, cam, smoke.WIDTH, smoke.HEIGHT)
    state0 = gmod.from_arrays(**smoke.perturbed(arrays), device=smoke.DEV)
    _, seen = smoke.train(state0, adam_mod.init(state0.params), cam,
                          gt.render, smoke.WIDTH, smoke.HEIGHT)
    b1_args, b3_args = smoke.kernel_inputs(seen, smoke.WIDTH, smoke.HEIGHT,
                                           smoke.MAX_INSTANCES)
    return (b1_args, b3_args, seen["composite_bwd_B4"][0],
            seen["reduce_B2"][:3])


def trainer_step_b2_inputs(path):
    """B2's inputs with the segments of chip_smoke.py's Trainer step (the
    tiles and M in `path`) and seeded random gradient columns."""
    with np.load(path) as z:
        tiles = torch.from_numpy(z["tiles"]).to(smoke.DEV)
        m = int(z["m"])
    exc = torch.cumsum(tiles, 0) - tiles
    gen = torch.Generator(device=smoke.DEV)
    gen.manual_seed(0)
    d = torch.randn((tile_render.GRAD_ROWS, m), generator=gen,
                    device=smoke.DEV)
    return d, exc, tiles


def time_in_turns(calls):
    """{name: median ms} over REPS rounds, each round calling every entry
    of `calls` once, in turn, behind a spin kernel."""
    for f in calls.values():
        f()
        f()
    times = {k: [] for k in calls}
    for _ in range(REPS):
        for k, f in calls.items():
            torch.cuda.synchronize()
            torch.cuda._sleep(smoke.SPIN_CYCLES)
            start = smoke._event()
            f()
            end = smoke._event()
            end.synchronize()
            times[k].append(start.elapsed_time(end))
    return {k: float(np.median(v)) for k, v in times.items()}


def main(parent, b2_step, out):
    if not torch.cuda.is_available():
        sys.exit("chip_ablate: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    t0 = time.perf_counter()
    _build.build_all()
    jobs = {}
    for name, src, edits in VARIANTS:
        include = _build.CSRC
        if name in HEADER_EDITS:
            include = ABLATE_DIR / f"{name}_include"
            include.mkdir(parents=True, exist_ok=True)
            (include / "composite_cull.cuh").write_text(variant_text(
                "composite_cull", HEADER_EDITS[name], ".cuh"))
        jobs[name] = (variant_text(src, edits), include)
    if parent is not None:
        pcsrc = parent / "rain_tpu_torch" / "csrc"
        jobs["b1_parent"] = ((pcsrc / "expand.cu").read_text(), pcsrc)
        jobs["b2_parent"] = ((pcsrc / "reduce.cu").read_text(), pcsrc)
    libs = build(jobs)
    print(f"build: {time.perf_counter() - t0:.2f} s")

    (b1_in, b1_kw), b3_args, b4_args, b2_in = step0_inputs()
    pack, starts, ends, toff, grid_x = b3_args
    m, n_tiles = pack.shape[1], starts.shape[0]
    tiles, g_tiles = b4_args[5], b4_args[6]
    order = tile_order(starts, ends)
    want3 = tile_render.composite_forward_torch(*b3_args)
    want4 = tile_render.composite_backward_torch(*b4_args)
    p = ctypes.c_void_p
    i32 = ctypes.c_int
    fwd_args = (p, ctypes.c_int64, p, p, i32, i32, i32, p)
    ordered_fwd_args = (p, ctypes.c_int64, p, p, p, i32, i32, i32, p)
    new_bwd = (p, ctypes.c_int64, p, p, i32, i32, i32, p, p, p)
    expand_args = (p, ctypes.c_int64, p, p, p, p, ctypes.c_int64, i32, i32,
                   i32, p, p)
    dev = smoke.DEV.index or 0

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def b1_call(lib):
        """B1's variants and its first design take the same C arguments."""
        f = entry(lib, "rain_expand_instances", expand_args)
        m1 = b1_kw["max_instances"]
        cols = torch.empty((expand_ops.ROWS, m1), device=smoke.DEV)
        keys = torch.empty((m1,), dtype=torch.int64, device=smoke.DEV)

        def call():
            if f(dev, stream(), b1_in[0].data_ptr(), b1_in[0].shape[1],
                 *(t.data_ptr() for t in b1_in[1:]), m1, b1_kw["grid_x"],
                 b1_kw["tile_offset"], b1_kw["n_tiles"], cols.data_ptr(),
                 keys.data_ptr()) != 0:
                raise RuntimeError("B1 variant failed")
            return cols, keys
        return call

    def fwd_call(lib):
        """B3 as the first design and the variants without an order call
        it (the same C arguments)."""
        f = entry(lib, "rain_composite_forward", fwd_args)
        out3 = torch.empty((n_tiles, tile_render.P, 8), device=smoke.DEV)

        def call():
            if f(dev, stream(), pack.data_ptr(), m, starts.data_ptr(),
                 ends.data_ptr(), n_tiles, toff, grid_x,
                 out3.data_ptr()) != 0:
                raise RuntimeError("B3 variant failed")
            return out3
        return call

    def ordered_fwd_call(lib, tile_list):
        f = entry(lib, "rain_composite_forward", ordered_fwd_args)
        out3 = torch.empty((n_tiles, tile_render.P, 8), device=smoke.DEV)

        def call():
            if f(dev, stream(), pack.data_ptr(), m, starts.data_ptr(),
                 ends.data_ptr(), tile_list().data_ptr(), n_tiles, toff,
                 grid_x, out3.data_ptr()) != 0:
                raise RuntimeError("B3 variant failed")
            return out3
        return call

    def bwd_call(lib, zero_fill=False):
        f = entry(lib, "rain_composite_backward", new_bwd)

        def call():
            d = (torch.zeros_like if zero_fill else torch.empty_like)(pack)
            if f(dev, stream(), pack.data_ptr(), m, starts.data_ptr(),
                 ends.data_ptr(), n_tiles, toff, grid_x, tiles.data_ptr(),
                 g_tiles.data_ptr(), d.data_ptr()) != 0:
                raise RuntimeError("B4 variant failed")
            return d
        return call

    b3 = {name: fwd_call(libs[name][0]) for name, src, _ in VARIANTS
          if src == "tile_render_fwd" and name != "fwd_heavy_first"}
    b3["fwd_heavy_first"] = ordered_fwd_call(libs["fwd_heavy_first"][0],
                                             lambda: order)
    b3["fwd_heavy_first_with_sort"] = ordered_fwd_call(
        libs["fwd_heavy_first"][0], lambda: tile_order(starts, ends))
    b3["tile_order_sort"] = lambda: tile_order(starts, ends)
    b4 = {name: bwd_call(libs[name][0])
          for name, src, _ in VARIANTS if src == "tile_render_bwd"}
    b4["bwd_full_zero_filled"] = bwd_call(libs["bwd_full"][0], True)
    b4["zero_fill_16xM"] = lambda: torch.zeros_like(pack)
    b1 = {name: b1_call(libs[name][0])
          for name in libs if name.startswith("b1_")}

    def b2_call(lib, d, exc, tiles_n):
        """B2's variants and its first design take the same C arguments."""
        f = entry(lib, "rain_reduce_instances", (
            p, i32, ctypes.c_int64, p, p, ctypes.c_int64, p))

        def call():
            o = torch.empty((d.shape[0], exc.shape[0]), device=smoke.DEV)
            if f(dev, stream(), d.data_ptr(), d.shape[0], d.shape[1],
                 exc.data_ptr(), tiles_n.data_ptr(), exc.shape[0],
                 o.data_ptr()) != 0:
                raise RuntimeError("B2 variant failed")
            return o
        return call

    b2_inputs = {"step0": b2_in}
    if b2_step is not None:
        b2_inputs["trainer_step"] = trainer_step_b2_inputs(b2_step)
    b2 = {where: {name: b2_call(libs[name][0], *args)
                  for name in libs if name.startswith("b2_")}
          for where, args in b2_inputs.items()}
    want1 = expand_ops.expand_instances_torch(*b1_in, **b1_kw)
    # the tile sort's pack, in one pass (binning.tile_sort) and in three
    # (the commit before), on B1's output, with and without the depth row
    cols1, keys1 = want1
    sorts = {f"tile_sort{tag}{'' if depth else '_no_depth'}":
             (lambda f=f, depth=depth: f(cols1, keys1, depth))
             for tag, f in (("", binning.tile_sort),
                            ("_3pass", tile_sort_3pass))
             for depth in (True, False)}

    checks = {}
    for where, calls in b2.items():
        want2 = expand_ops.reduce_instances_torch(*b2_inputs[where])
        for name, f in calls.items():
            got = f()
            torch.cuda.synchronize()
            if not smoke.bitwise_equal(got, want2):
                raise AssertionError(f"{name} differs from its plain version "
                                     f"at {where}")
            checks[f"{name}@{where}"] = "bitwise equal"
        del want2
    for name, f in b1.items():
        cols, keys = f()
        torch.cuda.synchronize()
        if not (torch.equal(keys, want1[1]) and
                smoke.bitwise_equal(cols, want1[0])):
            raise AssertionError(f"{name} differs from its plain version")
        checks[name] = "bitwise equal"
    for depth in ("", "_no_depth"):
        one, three = sorts[f"tile_sort{depth}"](), \
            sorts[f"tile_sort_3pass{depth}"]()
        if not (torch.equal(one[1], three[1]) and
                smoke.bitwise_equal(one[0], three[0])):
            raise AssertionError(f"tile_sort{depth} differs from the "
                                 f"three-pass version")
        checks[f"tile_sort{depth}"] = "bitwise equal to three passes"
    for name, f in list(b3.items()) + list(b4.items()):
        if name in ("tile_order_sort", "zero_fill_16xM"):
            continue
        got = f()
        torch.cuda.synchronize()
        want = want3 if name.startswith("fwd") else want4
        if name in REORDERED:
            err = (got - want).abs().amax(dim=1)
            rel = float((err[:tile_render.GRAD_ROWS] / want.abs().amax(
                dim=1)[:tile_render.GRAD_ROWS].clamp(min=1e-30)).max())
            if rel >= 1e-5:
                raise AssertionError(f"{name} off by {rel:.3g}")
            checks[name] = f"max rel error per row {rel:.3g}"
        elif not smoke.bitwise_equal(got, want):
            raise AssertionError(f"{name} differs from its plain version")
        else:
            checks[name] = "bitwise equal"
    ms = {"B1": time_in_turns(b1), "tile_sort": time_in_turns(sorts),
          "B3": time_in_turns(b3), "B4": time_in_turns(b4)}
    for where, calls in b2.items():
        ms[f"B2@{where}"] = time_in_turns(calls)
    record = {"card": smi, "reps": REPS, "checks": checks, "ms": ms,
              "ptxas": {k: v[1] for k, v in libs.items()},
              "blocks_per_sm": {
                  k: blocks_per_sm(lib, OCCUPANCY[k.split("_")[0]])
                  for k, (lib, _) in libs.items()}}
    for k, lines in record["ptxas"].items():
        check = "; ".join(f"{c}: {v}" for c, v in checks.items()
                          if c == k or c.startswith(k + "@"))
        print(f"{k}: {' | '.join(lines)}; blocks/SM "
              f"{record['blocks_per_sm'][k]}; {check}")
    if out is not None:
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps(record, indent=1))
    for kernel, times in ms.items():
        print(json.dumps({kernel: times}))
    print(smi)
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent", type=Path,
                        help="a checkout of an earlier commit, whose B1 and "
                             "B2 are timed beside these")
    parser.add_argument("--b2-step", type=Path,
                        help="chip_smoke.py's b2_trainer_step.npz: time B2 "
                             "at those segments too")
    parser.add_argument("--out", type=Path,
                        help="write the run's record to this JSON file")
    args = parser.parse_args()
    main(args.parent, args.b2_step, args.out)
