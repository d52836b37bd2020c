// Shared by the kernel sources: the fan-in values the kernels are
// instantiated for.  A kernel keeps r values per row in registers, so r is a
// template parameter; the C entry points switch on it with this list.
#pragma once

#define FLGP_R_CASES(X) \
  X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)
