// Token-level continuation math + small helpers.
//
// C++ equivalent of the reference's utils.rs (SURVEY.md C16e): merging
// partial responses (output_token_logprobs arrays + completion counts,
// utils.rs:19-86), extending input_ids with already-generated tokens
// (:140-182), and shrinking max_new_tokens by used tokens (:256-291) so a
// request evicted from a dying instance resumes on another one from the
// last generated token. Pure functions on JSON values — table-testable.
#pragma once

#include <string>
#include <vector>

#include "json.h"

namespace manager {

// Accumulated state of one in-flight request across attempts.
struct PartialResponse {
  std::vector<int64_t> token_ids;
  std::vector<double> logprobs;
  // per-token engine weight version (token-level continuous generation:
  // a resume that crosses a weight push stitches tokens sampled under
  // DIFFERENT policies — the trainer's truncated-importance correction
  // needs to know which). -1 = engine did not report one.
  std::vector<int64_t> weight_versions;
  std::string finish_reason;  // "" until finished
  bool finished = false;
};

// Fold one streamed chunk ({"token_ids":[...], "logprobs":[...],
// "finished":bool, "finish_reason":str, "weight_version":int?}) into the
// accumulator.
inline void merge_chunk(PartialResponse& acc, const pjson::Value& chunk) {
  int64_t wv = chunk["weight_version"].as_int(-1);
  for (const auto& t : chunk["token_ids"].as_arr()) {
    acc.token_ids.push_back(t.as_int());
    acc.weight_versions.push_back(wv);
  }
  for (const auto& l : chunk["logprobs"].as_arr())
    acc.logprobs.push_back(l.as_num());
  if (chunk["finished"].as_bool()) {
    acc.finished = true;
    acc.finish_reason = chunk["finish_reason"].as_str();
    if (acc.finish_reason.empty()) acc.finish_reason = "stop";
  }
}

// Build the continuation request: original prompt + generated-so-far tokens
// become the new prompt; the token budget shrinks by what was used.
// (reference extend_input_ids_with_response_tokens +
// adjust_sampling_params_for_used_tokens)
inline pjson::Value build_continuation_request(const pjson::Value& orig_request,
                                               const PartialResponse& partial) {
  pjson::Array new_ids;
  for (const auto& t : orig_request["input_ids"].as_arr()) new_ids.push_back(t);
  for (int64_t t : partial.token_ids) new_ids.push_back(pjson::Value(t));

  pjson::Object sp = orig_request["sampling_params"].as_obj();
  int64_t max_new = orig_request["sampling_params"]["max_new_tokens"].as_int(128);
  int64_t used = static_cast<int64_t>(partial.token_ids.size());
  sp["max_new_tokens"] = pjson::Value(std::max<int64_t>(max_new - used, 1));

  pjson::Object out = orig_request.as_obj();
  out["input_ids"] = pjson::Value(std::move(new_ids));
  out["sampling_params"] = pjson::Value(std::move(sp));
  return pjson::Value(std::move(out));
}

// Final response for the trainer: all attempts' tokens/logprobs merged.
inline pjson::Value build_final_response(const std::string& rid,
                                         const PartialResponse& acc) {
  pjson::Array ids, lps, wvs;
  for (int64_t t : acc.token_ids) ids.push_back(pjson::Value(t));
  for (double l : acc.logprobs) lps.push_back(pjson::Value(l));
  for (int64_t v : acc.weight_versions) wvs.push_back(pjson::Value(v));
  pjson::Object o;
  o["rid"] = pjson::Value(rid);
  o["success"] = pjson::Value(true);
  o["output_token_ids"] = pjson::Value(std::move(ids));
  o["output_token_logprobs"] = pjson::Value(std::move(lps));
  o["output_token_weight_versions"] = pjson::Value(std::move(wvs));
  o["finish_reason"] =
      pjson::Value(acc.finish_reason.empty() ? "abort" : acc.finish_reason);
  o["completion_tokens"] = pjson::Value(static_cast<int64_t>(acc.token_ids.size()));
  return pjson::Value(std::move(o));
}

inline pjson::Value error_response(const std::string& rid, const std::string& err) {
  pjson::Object o;
  o["rid"] = pjson::Value(rid);
  o["success"] = pjson::Value(false);
  o["error"] = pjson::Value(err);
  return pjson::Value(std::move(o));
}

}  // namespace manager
