// The head dims every attention kernel of the port is instantiated for
// (flash forward and backward, paged decode), as X(D) arms: the multiples
// of 16 up to 192, q, k and v alike. A source expands REPRO_HEAD_DIMS(ARM) into its switch
// over D. The Python wrappers read this list too
// (repro_torch.kernels._build.HEAD_DIMS), so it is kept here only.
#pragma once

#define REPRO_HEAD_DIMS(X)                                                  \
  X(16) X(32) X(48) X(64) X(80) X(96) X(112) X(128) X(144) X(160) X(176)  \
  X(192)

// The (q/k head dim, value head dim) pairs with a narrower value head the
// flash kernels (bf16 forward and backward) are instantiated for, as
// X(D, DV) arms: latent attention's 128 + 64 RoPE q/k heads beside 128-wide
// values. The Python wrappers read this list too
// (repro_torch.kernels._build.HEAD_DIM_PAIRS).
#define REPRO_HEAD_DIM_PAIRS(X) X(192, 128)
