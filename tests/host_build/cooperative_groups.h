// Host stand-in for cooperative_groups.h: the grid group lives in the
// stand-in cuda_runtime.h.
#pragma once
#include "cuda_runtime.h"
