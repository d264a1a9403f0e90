// Vose alias table, host side: the benchmark's frozen copy of the port's
// csrc/alias_table.cpp (itself a copy of build_alias_table in the reference
// package's native/raytracing_native.cpp; upstream src/environments.rs:96-187),
// built with g++ by portbench/reference/env.py and bound with ctypes.
//
// `probabilities` must already be normalized to mean 1 (float32 math, as
// the reference does). Returns the number of leftover (identity) entries.

#include <cstdint>
#include <vector>

extern "C" {

int64_t build_alias_table(
    const float* probabilities,
    int64_t length,
    float* out_probability,
    int32_t* out_alias,
    float* out_pmf)
{
    std::vector<float> alias_probabilities(probabilities, probabilities + length);
    // Divide, never multiply by the reciprocal: the numpy builder and the
    // reference compute pmf = p / length, and for non-power-of-two lengths
    // p * (1/length) differs by 1 ulp on ~22% of entries.
    const float f_length = static_cast<float>(length);

    // Defaults: identity entries (probability 1, alias self) with their
    // true weight-proportional pmf (see env/alias_table.py).
    for (int64_t i = 0; i < length; ++i) {
        out_probability[i] = 1.0f;
        out_alias[i] = static_cast<int32_t>(i);
        out_pmf[i] = probabilities[i] / f_length;
    }

    std::vector<int64_t> small;
    std::vector<int64_t> large;
    small.reserve(length);
    large.reserve(length);
    for (int64_t i = 0; i < length; ++i) {
        if (probabilities[i] < 1.0f) small.push_back(i);
        else large.push_back(i);
    }

    int64_t assigned = 0;
    while (!small.empty() && !large.empty()) {
        const int64_t s = small.back(); small.pop_back();
        const int64_t l = large.back(); large.pop_back();

        out_probability[s] = alias_probabilities[s];
        out_alias[s] = static_cast<int32_t>(l);
        out_pmf[s] = probabilities[s] / f_length;
        ++assigned;

        alias_probabilities[l] =
            alias_probabilities[l] - (1.0f - alias_probabilities[s]);
        if (alias_probabilities[l] < 1.0f) small.push_back(l);
        else large.push_back(l);
    }
    return length - assigned;
}

}  // extern "C"
