// Minimal JSON DOM: parse/serialize, no external deps.
// Part of the TPU-native rollout manager (C++ equivalent of the reference's
// Rust rollout-manager, SURVEY.md C16; serde role).
#pragma once

#include <cmath>
#include <cstdint>
#include <limits>
#include <map>
#include <memory>
#include <sstream>
#include <stdexcept>
#include <string>
#include <vector>

namespace pjson {

class Value;
using Array = std::vector<Value>;
using Object = std::map<std::string, Value>;

class Value {
 public:
  enum class Type { Null, Bool, Num, Str, Arr, Obj };

  Value() : type_(Type::Null) {}
  Value(std::nullptr_t) : type_(Type::Null) {}
  Value(bool b) : type_(Type::Bool), bool_(b) {}
  Value(int v) : type_(Type::Num), num_(v) {}
  Value(int64_t v) : type_(Type::Num), num_(static_cast<double>(v)) {}
  Value(size_t v) : type_(Type::Num), num_(static_cast<double>(v)) {}
  Value(double v) : type_(Type::Num), num_(v) {}
  Value(const char* s) : type_(Type::Str), str_(s) {}
  Value(std::string s) : type_(Type::Str), str_(std::move(s)) {}
  Value(Array a) : type_(Type::Arr), arr_(std::make_shared<Array>(std::move(a))) {}
  Value(Object o) : type_(Type::Obj), obj_(std::make_shared<Object>(std::move(o))) {}

  Type type() const { return type_; }
  bool is_null() const { return type_ == Type::Null; }
  bool is_bool() const { return type_ == Type::Bool; }
  bool is_num() const { return type_ == Type::Num; }
  bool is_str() const { return type_ == Type::Str; }
  bool is_arr() const { return type_ == Type::Arr; }
  bool is_obj() const { return type_ == Type::Obj; }

  bool as_bool(bool dflt = false) const { return is_bool() ? bool_ : dflt; }
  double as_num(double dflt = 0) const { return is_num() ? num_ : dflt; }
  int64_t as_int(int64_t dflt = 0) const {
    // non-finite → dflt: casting NaN/Inf to int64 is UB, and the parser
    // can legitimately produce such values from engine streams
    return is_num() && std::isfinite(num_) ? static_cast<int64_t>(num_) : dflt;
  }
  const std::string& as_str() const {
    static const std::string empty;
    return is_str() ? str_ : empty;
  }
  const Array& as_arr() const {
    static const Array empty;
    return is_arr() ? *arr_ : empty;
  }
  Array& mut_arr() {
    if (!is_arr()) { type_ = Type::Arr; arr_ = std::make_shared<Array>(); }
    return *arr_;
  }
  const Object& as_obj() const {
    static const Object empty;
    return is_obj() ? *obj_ : empty;
  }
  Object& mut_obj() {
    if (!is_obj()) { type_ = Type::Obj; obj_ = std::make_shared<Object>(); }
    return *obj_;
  }

  // object field access (null if missing)
  const Value& operator[](const std::string& k) const {
    static const Value null_v;
    if (!is_obj()) return null_v;
    auto it = obj_->find(k);
    return it == obj_->end() ? null_v : it->second;
  }
  bool has(const std::string& k) const {
    return is_obj() && obj_->count(k) > 0;
  }
  void set(const std::string& k, Value v) { mut_obj()[k] = std::move(v); }

  std::string dump() const {
    std::ostringstream os;
    write(os);
    return os.str();
  }

  void write(std::ostream& os) const {
    switch (type_) {
      case Type::Null: os << "null"; break;
      case Type::Bool: os << (bool_ ? "true" : "false"); break;
      case Type::Num: {
        if (std::isnan(num_)) {
          // match Python's json: "nan"/"inf" from ostream would be
          // unparseable on the trainer side, killing the whole stream
          os << "NaN";
        } else if (std::isinf(num_)) {
          os << (num_ < 0 ? "-Infinity" : "Infinity");
        } else if (num_ == std::floor(num_) && std::fabs(num_) < 9.0e15) {
          os << static_cast<int64_t>(num_);
        } else {
          std::ostringstream tmp;
          tmp.precision(17);
          tmp << num_;
          os << tmp.str();
        }
        break;
      }
      case Type::Str: write_escaped(os, str_); break;
      case Type::Arr: {
        os << '[';
        bool first = true;
        for (const auto& v : *arr_) {
          if (!first) os << ',';
          first = false;
          v.write(os);
        }
        os << ']';
        break;
      }
      case Type::Obj: {
        os << '{';
        bool first = true;
        for (const auto& [k, v] : *obj_) {
          if (!first) os << ',';
          first = false;
          write_escaped(os, k);
          os << ':';
          v.write(os);
        }
        os << '}';
        break;
      }
    }
  }

 private:
  static void write_escaped(std::ostream& os, const std::string& s) {
    os << '"';
    for (char c : s) {
      switch (c) {
        case '"': os << "\\\""; break;
        case '\\': os << "\\\\"; break;
        case '\n': os << "\\n"; break;
        case '\r': os << "\\r"; break;
        case '\t': os << "\\t"; break;
        default:
          if (static_cast<unsigned char>(c) < 0x20) {
            char buf[8];
            snprintf(buf, sizeof(buf), "\\u%04x", c);
            os << buf;
          } else {
            os << c;
          }
      }
    }
    os << '"';
  }

  Type type_;
  bool bool_ = false;
  double num_ = 0;
  std::string str_;
  std::shared_ptr<Array> arr_;
  std::shared_ptr<Object> obj_;
};

// ---- parser ---------------------------------------------------------------

class Parser {
 public:
  explicit Parser(const std::string& s) : s_(s) {}

  Value parse() {
    skip_ws();
    Value v = parse_value();
    skip_ws();
    return v;
  }

  static Value parse(const std::string& s, bool* ok = nullptr) {
    try {
      Parser p(s);
      Value v = p.parse();
      if (ok) *ok = true;
      return v;
    } catch (const std::exception&) {
      if (ok) *ok = false;
      return Value();
    }
  }

 private:
  void skip_ws() {
    while (i_ < s_.size() && (s_[i_] == ' ' || s_[i_] == '\t' || s_[i_] == '\n' || s_[i_] == '\r'))
      ++i_;
  }
  char peek() {
    if (i_ >= s_.size()) throw std::runtime_error("json: eof");
    return s_[i_];
  }
  char next() {
    char c = peek();
    ++i_;
    return c;
  }
  void expect(const char* lit) {
    for (const char* p = lit; *p; ++p)
      if (i_ >= s_.size() || s_[i_++] != *p) throw std::runtime_error("json: bad literal");
  }

  Value parse_value() {
    skip_ws();
    char c = peek();
    switch (c) {
      case '{': return parse_object();
      case '[': return parse_array();
      case '"': return Value(parse_string());
      case 't': expect("true"); return Value(true);
      case 'f': expect("false"); return Value(false);
      case 'n': expect("null"); return Value();
      default: return parse_number();
    }
  }

  Value parse_object() {
    next();  // {
    Object o;
    skip_ws();
    if (peek() == '}') { next(); return Value(std::move(o)); }
    while (true) {
      skip_ws();
      std::string key = parse_string();
      skip_ws();
      if (next() != ':') throw std::runtime_error("json: expected :");
      o[std::move(key)] = parse_value();
      skip_ws();
      char c = next();
      if (c == '}') break;
      if (c != ',') throw std::runtime_error("json: expected , or }");
    }
    return Value(std::move(o));
  }

  Value parse_array() {
    next();  // [
    Array a;
    skip_ws();
    if (peek() == ']') { next(); return Value(std::move(a)); }
    while (true) {
      a.push_back(parse_value());
      skip_ws();
      char c = next();
      if (c == ']') break;
      if (c != ',') throw std::runtime_error("json: expected , or ]");
    }
    return Value(std::move(a));
  }

  std::string parse_string() {
    if (next() != '"') throw std::runtime_error("json: expected string");
    std::string out;
    while (true) {
      char c = next();
      if (c == '"') break;
      if (c == '\\') {
        char e = next();
        switch (e) {
          case '"': out += '"'; break;
          case '\\': out += '\\'; break;
          case '/': out += '/'; break;
          case 'b': out += '\b'; break;
          case 'f': out += '\f'; break;
          case 'n': out += '\n'; break;
          case 'r': out += '\r'; break;
          case 't': out += '\t'; break;
          case 'u': {
            unsigned code = 0;
            for (int k = 0; k < 4; ++k) {
              char h = next();
              code <<= 4;
              if (h >= '0' && h <= '9') code |= h - '0';
              else if (h >= 'a' && h <= 'f') code |= h - 'a' + 10;
              else if (h >= 'A' && h <= 'F') code |= h - 'A' + 10;
              else throw std::runtime_error("json: bad \\u");
            }
            // utf-8 encode (BMP only; surrogate pairs folded naively)
            if (code < 0x80) out += static_cast<char>(code);
            else if (code < 0x800) {
              out += static_cast<char>(0xC0 | (code >> 6));
              out += static_cast<char>(0x80 | (code & 0x3F));
            } else {
              out += static_cast<char>(0xE0 | (code >> 12));
              out += static_cast<char>(0x80 | ((code >> 6) & 0x3F));
              out += static_cast<char>(0x80 | (code & 0x3F));
            }
            break;
          }
          default: throw std::runtime_error("json: bad escape");
        }
      } else {
        out += c;
      }
    }
    return out;
  }

  Value parse_number() {
    size_t start = i_;
    bool neg = false;
    if (peek() == '-') { neg = true; next(); }
    // Python's json.dumps emits NaN/Infinity/-Infinity for non-finite
    // floats (not valid JSON, but real engines under test have produced
    // them) — parse the EXACT literals instead of throwing, so one bad
    // float can't kill a whole stream. Anything else alphabetic is still a
    // decode error (a plaintext body must not silently become Infinity).
    if (peek() == 'N' || peek() == 'I') {
      size_t lit_start = i_;
      while (i_ < s_.size() && isalpha(s_[i_])) ++i_;
      std::string lit = s_.substr(lit_start, i_ - lit_start);
      if (lit == "NaN")
        return Value(std::numeric_limits<double>::quiet_NaN());  // -NaN == NaN
      if (lit == "Infinity")
        return Value(neg ? -std::numeric_limits<double>::infinity()
                         : std::numeric_limits<double>::infinity());
      throw std::runtime_error("json: bad literal " + lit);
    }
    while (i_ < s_.size() && (isdigit(s_[i_]) || s_[i_] == '.' || s_[i_] == 'e' ||
                              s_[i_] == 'E' || s_[i_] == '+' || s_[i_] == '-'))
      ++i_;
    return Value(std::stod(s_.substr(start, i_ - start)));
  }

  const std::string& s_;
  size_t i_ = 0;
};

}  // namespace pjson
