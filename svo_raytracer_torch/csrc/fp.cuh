// Float helpers shared by the per-ray kernel bodies: min and max that
// propagate NaN as torch.minimum / torch.maximum (and jnp.minimum /
// jnp.maximum) do, where fminf / fmaxf would drop it.
#pragma once

namespace fp {

__host__ __device__ inline float minf(float a, float b) {
  return a != a ? a : (b != b ? b : (b < a ? b : a));
}

__host__ __device__ inline float maxf(float a, float b) {
  return a != a ? a : (b != b ? b : (b > a ? b : a));
}

}  // namespace fp
