// Native .lol scene parser: tokenizer + recursive descent + semantic
// extraction, C ABI for Python ctypes binding.
//
// This is the framework's native counterpart of the reference's
// flex/bison frontend (scene-lexer.l, scene-parser.y, scene.c): same token
// set (including the '-'/'_' keyword alias spellings, scene-lexer.l:20-26,
// 36-39), same grammar (scene-parser.y:73-189), same semantic passes
// (zero defaults via value-initialization; camera direction normalization
// and degrees->radians, scene.c:173-174; plane anchoring, scene.c:215;
// material index validation, scene.c:284-292). Deliberately strict where
// the reference lexer was sloppy (SURVEY.md §2.1.10): malformed numbers,
// unknown characters and unknown keywords are errors with line numbers.
//
// Output: a JSON rendering of the parsed scene (or {"error","line"}), so
// the Python side stays schema-driven; floats are emitted with %.9g which
// round-trips float32 exactly.

#include <cctype>
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

struct ParseError {
  std::string message;
  int line;
  ParseError(std::string m, int l) : message(std::move(m)), line(l) {}
};

// ---------------------------------------------------------------- tokens --

enum class Tok {
  Num, MatId, Word,
  Comma, LParen, RParen, LBrace, RBrace, Equals,
  End
};

struct Token {
  Tok kind;
  double num = 0;
  long id = 0;
  std::string word;  // canonical keyword spelling
  int line = 1;
};

const char* kKeywords[][2] = {
    // spelling -> canonical
    {"materials", "materials"}, {"scene", "scene"},
    {"ambient", "ambient"}, {"camera", "camera"},
    {"point_light", "point_light"}, {"point-light", "point_light"},
    {"sphere", "sphere"}, {"box", "box"}, {"plane", "plane"},
    {"smooth_union", "smooth_union"}, {"smooth-union", "smooth_union"},
    {"shininess", "shininess"}, {"diffuse", "diffuse"},
    {"specular", "specular"}, {"color", "color"}, {"point", "point"},
    {"direction", "direction"}, {"fov", "fov"},
    {"diffuse_intensity", "diffuse_intensity"},
    {"diffuse-intensity", "diffuse_intensity"},
    {"specular_intensity", "specular_intensity"},
    {"specular-intensity", "specular_intensity"},
    {"radius", "radius"}, {"material", "material"}, {"point2", "point2"},
    {"y", "y"}, {"smoothness", "smoothness"}, {"a", "a"}, {"b", "b"},
};

std::vector<Token> tokenize(const std::string& text) {
  std::vector<Token> out;
  int line = 1;
  size_t i = 0;
  const size_t n = text.size();
  while (i < n) {
    char c = text[i];
    if (c == '\n') { line++; i++; continue; }
    if (c == ' ' || c == '\t' || c == '\r') { i++; continue; }
    if (c == '#') {
      size_t j = i + 1;
      while (j < n && isdigit((unsigned char)text[j])) j++;
      if (j == i + 1) throw ParseError("expected digits after '#'", line);
      Token t; t.kind = Tok::MatId; t.line = line;
      t.id = strtol(text.substr(i + 1, j - i - 1).c_str(), nullptr, 10);
      out.push_back(t);
      i = j;
      continue;
    }
    if (c == '-' || c == '.' || isdigit((unsigned char)c)) {
      // strict float: -?(\d+\.?\d* | .\d+)
      size_t j = i;
      if (text[j] == '-') j++;
      size_t digits = 0, dots = 0;
      size_t k = j;
      while (k < n && (isdigit((unsigned char)text[k]) || text[k] == '.')) {
        if (text[k] == '.') dots++; else digits++;
        k++;
      }
      if (digits == 0 || dots > 1)
        throw ParseError("malformed number '" + text.substr(i, k - i) + "'",
                         line);
      Token t; t.kind = Tok::Num; t.line = line;
      t.num = strtod(text.substr(i, k - i).c_str(), nullptr);
      out.push_back(t);
      i = k;
      continue;
    }
    if (isalpha((unsigned char)c)) {
      size_t j = i;
      while (j < n && (isalnum((unsigned char)text[j]) || text[j] == '_' ||
                       text[j] == '-'))
        j++;
      std::string word = text.substr(i, j - i);
      const char* canon = nullptr;
      for (auto& kw : kKeywords)
        if (word == kw[0]) { canon = kw[1]; break; }
      if (!canon) throw ParseError("unknown keyword '" + word + "'", line);
      Token t; t.kind = Tok::Word; t.word = canon; t.line = line;
      out.push_back(t);
      i = j;
      continue;
    }
    Tok k;
    switch (c) {
      case ',': k = Tok::Comma; break;
      case '(': k = Tok::LParen; break;
      case ')': k = Tok::RParen; break;
      case '{': k = Tok::LBrace; break;
      case '}': k = Tok::RBrace; break;
      case '=': k = Tok::Equals; break;
      default:
        throw ParseError(std::string("unexpected character '") + c + "'",
                         line);
    }
    Token t; t.kind = k; t.line = line;
    out.push_back(t);
    i++;
  }
  Token t; t.kind = Tok::End; t.line = line;
  out.push_back(t);
  return out;
}

// ------------------------------------------------------------------- AST --

struct Vec3 { double x = 0, y = 0, z = 0; };

struct Material {
  double shininess = 0;
  Vec3 diffuse, specular, ambient;
};

struct Light {
  Vec3 point, diffuse_intensity, specular_intensity;
};

struct Object {
  std::string type;  // sphere | box | plane | smooth_union
  Vec3 point, point2;
  double radius = 0, y = 0, smoothness = 0;
  long material = 0;
  std::unique_ptr<Object> a, b;
};

struct Camera {
  Vec3 point;
  Vec3 direction{0, 0, 1};
  double fov = M_PI / 2;
  bool specified = false;
};

struct SceneAst {
  std::vector<Material> materials;
  Vec3 ambient_color;
  std::vector<Light> lights;
  std::vector<Object> objects;
  Camera camera;
};

// ------------------------------------------------------------ the parser --

struct Value {
  enum Kind { NumV, ListV, IdV, ObjV } kind;
  double num = 0;
  std::vector<double> list;
  long id = 0;
  std::unique_ptr<Object> obj;
};

struct Definition {
  std::string prop;
  Value value;
  int line;
};

class Parser {
 public:
  explicit Parser(std::vector<Token> toks) : toks_(std::move(toks)) {}

  SceneAst parse() {
    SceneAst scene;
    scene.materials = parse_materials();
    parse_scene(scene);
    expect(Tok::End, "end of input");
    // material index validation (scene.c:284-292), incl. CSG children
    for (auto& o : scene.objects) validate_materials(o, scene.materials.size());
    return scene;
  }

 private:
  std::vector<Token> toks_;
  size_t i_ = 0;

  const Token& peek() { return toks_[i_]; }
  const Token& next() { return toks_[i_++]; }
  const Token& expect(Tok k, const char* what) {
    const Token& t = next();
    if (t.kind != k)
      throw ParseError(std::string("expected ") + what, t.line);
    return t;
  }
  bool is_word(const Token& t, const char* w) {
    return t.kind == Tok::Word && t.word == w;
  }

  void validate_materials(const Object& o, size_t count) {
    if ((size_t)o.material >= count)
      throw ParseError("an object references a material index out of range",
                       0);
    if (o.a) validate_materials(*o.a, count);
    if (o.b) validate_materials(*o.b, count);
  }

  std::vector<Material> parse_materials() {
    const Token& t = next();
    if (!is_word(t, "materials"))
      throw ParseError("expected 'materials'", t.line);
    expect(Tok::LBrace, "'{'");
    std::vector<Material> mats;
    mats.push_back(parse_material());
    while (peek().kind == Tok::Comma) { next(); mats.push_back(parse_material()); }
    expect(Tok::RBrace, "'}'");
    return mats;
  }

  Material parse_material() {
    int line = peek().line;
    expect(Tok::LBrace, "'{'");
    auto defs = parse_definition_list();
    expect(Tok::RBrace, "'}'");
    Material m;
    for (auto& d : defs) {
      if (d.prop == "shininess") m.shininess = as_num(d);
      else if (d.prop == "diffuse") m.diffuse = as_v3(d);
      else if (d.prop == "specular") m.specular = as_v3(d);
      else if (d.prop == "ambient") m.ambient = as_v3(d);
      else throw ParseError("unknown material property '" + d.prop + "'", d.line);
    }
    (void)line;
    return m;
  }

  void parse_scene(SceneAst& scene) {
    const Token& t = next();
    if (!is_word(t, "scene")) throw ParseError("expected 'scene'", t.line);
    expect(Tok::LBrace, "'{'");
    parse_component(scene);
    while (peek().kind == Tok::Comma) { next(); parse_component(scene); }
    expect(Tok::RBrace, "'}'");
  }

  static const bool is_object_type(const std::string& w) {
    return w == "sphere" || w == "box" || w == "plane" || w == "smooth_union";
  }

  void parse_component(SceneAst& scene) {
    const Token& t = next();
    if (t.kind != Tok::Word)
      throw ParseError("expected a component type", t.line);
    const std::string kind = t.word;
    expect(Tok::LBrace, "'{'");
    auto defs = parse_definition_list();
    expect(Tok::RBrace, "'}'");

    if (kind == "ambient") {
      for (auto& d : defs) {
        if (d.prop == "color") scene.ambient_color = as_v3(d);
        else throw ParseError("unknown ambient property '" + d.prop + "'", d.line);
      }
    } else if (kind == "camera") {
      Camera cam;
      cam.point = Vec3{};
      cam.direction = Vec3{};
      cam.fov = 0;
      for (auto& d : defs) {
        if (d.prop == "point") cam.point = as_v3(d);
        else if (d.prop == "direction") cam.direction = as_v3(d);
        else if (d.prop == "fov") cam.fov = as_num(d);
        else throw ParseError("unknown camera property '" + d.prop + "'", d.line);
      }
      double n = std::sqrt(cam.direction.x * cam.direction.x +
                           cam.direction.y * cam.direction.y +
                           cam.direction.z * cam.direction.z);
      if (n == 0.0)
        throw ParseError("camera direction must be non-zero", t.line);
      cam.direction = Vec3{cam.direction.x / n, cam.direction.y / n,
                           cam.direction.z / n};
      cam.fov = cam.fov / 180.0 * M_PI;
      cam.specified = true;
      scene.camera = cam;
    } else if (kind == "point_light") {
      Light l;
      for (auto& d : defs) {
        if (d.prop == "point") l.point = as_v3(d);
        else if (d.prop == "diffuse_intensity") l.diffuse_intensity = as_v3(d);
        else if (d.prop == "specular_intensity") l.specular_intensity = as_v3(d);
        else throw ParseError("unknown point_light property '" + d.prop + "'", d.line);
      }
      scene.lights.push_back(l);
    } else if (is_object_type(kind)) {
      scene.objects.push_back(std::move(*object_from_defs(kind, defs, t.line)));
    } else {
      throw ParseError("expected a component type, found '" + kind + "'",
                       t.line);
    }
  }

  std::unique_ptr<Object> object_from_defs(const std::string& kind,
                                           std::vector<Definition>& defs,
                                           int line) {
    auto obj = std::make_unique<Object>();
    obj->type = kind;
    bool has_a = false, has_b = false;
    for (auto& d : defs) {
      if (d.prop == "material") { obj->material = as_id(d); continue; }
      if (kind == "sphere") {
        if (d.prop == "point") { obj->point = as_v3(d); continue; }
        if (d.prop == "radius") { obj->radius = as_num(d); continue; }
      } else if (kind == "box") {
        if (d.prop == "point") { obj->point = as_v3(d); continue; }
        if (d.prop == "point2") { obj->point2 = as_v3(d); continue; }
        if (d.prop == "radius") { obj->radius = as_num(d); continue; }
      } else if (kind == "plane") {
        if (d.prop == "y") { obj->y = as_num(d); continue; }
      } else if (kind == "smooth_union") {
        if (d.prop == "smoothness") { obj->smoothness = as_num(d); continue; }
        if (d.prop == "a") { obj->a = as_obj(d); has_a = true; continue; }
        if (d.prop == "b") { obj->b = as_obj(d); has_b = true; continue; }
      }
      throw ParseError("unknown " + kind + " property '" + d.prop + "'",
                       d.line);
    }
    if (kind == "smooth_union" && (!has_a || !has_b))
      throw ParseError("smooth_union requires both 'a' and 'b' children",
                       line);
    return obj;
  }

  std::vector<Definition> parse_definition_list() {
    std::vector<Definition> defs;
    defs.push_back(parse_definition());
    while (peek().kind == Tok::Comma) { next(); defs.push_back(parse_definition()); }
    return defs;
  }

  Definition parse_definition() {
    const Token& t = next();
    if (t.kind != Tok::Word)
      throw ParseError("expected a property name", t.line);
    expect(Tok::Equals, "'='");
    Definition d;
    d.prop = t.word;
    d.line = t.line;
    d.value = parse_value();
    return d;
  }

  Value parse_value() {
    const Token& t = peek();
    Value v;
    if (t.kind == Tok::Num) {
      next();
      v.kind = Value::NumV; v.num = t.num;
      return v;
    }
    if (t.kind == Tok::MatId) {
      next();
      v.kind = Value::IdV; v.id = t.id;
      return v;
    }
    if (t.kind == Tok::LParen) {
      next();
      v.kind = Value::ListV;
      v.list.push_back(expect(Tok::Num, "a number").num);
      while (peek().kind == Tok::Comma) {
        next();
        v.list.push_back(expect(Tok::Num, "a number").num);
      }
      expect(Tok::RParen, "')'");
      return v;
    }
    if (t.kind == Tok::Word && is_object_type(t.word)) {
      next();
      expect(Tok::LBrace, "'{'");
      auto defs = parse_definition_list();
      expect(Tok::RBrace, "'}'");
      v.kind = Value::ObjV;
      v.obj = object_from_defs(t.word, defs, t.line);
      return v;
    }
    throw ParseError("expected a value", t.line);
  }

  double as_num(Definition& d) {
    if (d.value.kind != Value::NumV)
      throw ParseError("property '" + d.prop + "' expects a number", d.line);
    return d.value.num;
  }
  Vec3 as_v3(Definition& d) {
    if (d.value.kind != Value::ListV || d.value.list.size() != 3)
      throw ParseError(
          "property '" + d.prop + "' expects a 3-component vector", d.line);
    return Vec3{d.value.list[0], d.value.list[1], d.value.list[2]};
  }
  long as_id(Definition& d) {
    if (d.value.kind != Value::IdV)
      throw ParseError("property '" + d.prop + "' expects a material #id",
                       d.line);
    return d.value.id;
  }
  std::unique_ptr<Object> as_obj(Definition& d) {
    if (d.value.kind != Value::ObjV)
      throw ParseError("property '" + d.prop + "' expects a nested object",
                       d.line);
    return std::move(d.value.obj);
  }
};

// ------------------------------------------------------------ JSON output --

void jnum(std::string& out, double v) {
  char buf[64];
  snprintf(buf, sizeof buf, "%.17g", v);
  out += buf;
}

void jv3(std::string& out, const Vec3& v) {
  out += "[";
  jnum(out, v.x); out += ",";
  jnum(out, v.y); out += ",";
  jnum(out, v.z); out += "]";
}

void jobject(std::string& out, const Object& o) {
  out += "{\"type\":\"" + o.type + "\",\"material\":" +
         std::to_string(o.material);
  if (o.type == "sphere") {
    out += ",\"point\":"; jv3(out, o.point);
    out += ",\"radius\":"; jnum(out, o.radius);
  } else if (o.type == "box") {
    out += ",\"point\":"; jv3(out, o.point);
    out += ",\"point2\":"; jv3(out, o.point2);
    out += ",\"radius\":"; jnum(out, o.radius);
  } else if (o.type == "plane") {
    out += ",\"y\":"; jnum(out, o.y);
  } else {  // smooth_union
    out += ",\"smoothness\":"; jnum(out, o.smoothness);
    out += ",\"a\":"; jobject(out, *o.a);
    out += ",\"b\":"; jobject(out, *o.b);
  }
  out += "}";
}

std::string to_json(const SceneAst& s) {
  std::string out = "{\"materials\":[";
  for (size_t i = 0; i < s.materials.size(); i++) {
    if (i) out += ",";
    const Material& m = s.materials[i];
    out += "{\"shininess\":"; jnum(out, m.shininess);
    out += ",\"diffuse\":"; jv3(out, m.diffuse);
    out += ",\"specular\":"; jv3(out, m.specular);
    out += ",\"ambient\":"; jv3(out, m.ambient);
    out += "}";
  }
  out += "],\"ambient_color\":"; jv3(out, s.ambient_color);
  out += ",\"camera\":{\"point\":"; jv3(out, s.camera.point);
  out += ",\"direction\":"; jv3(out, s.camera.direction);
  out += ",\"fov\":"; jnum(out, s.camera.fov);
  out += "},\"lights\":[";
  for (size_t i = 0; i < s.lights.size(); i++) {
    if (i) out += ",";
    out += "{\"point\":"; jv3(out, s.lights[i].point);
    out += ",\"diffuse_intensity\":"; jv3(out, s.lights[i].diffuse_intensity);
    out += ",\"specular_intensity\":"; jv3(out, s.lights[i].specular_intensity);
    out += "}";
  }
  out += "],\"objects\":[";
  for (size_t i = 0; i < s.objects.size(); i++) {
    if (i) out += ",";
    jobject(out, s.objects[i]);
  }
  out += "]}";
  return out;
}

std::string escape(const std::string& s) {
  std::string out;
  for (char c : s) {
    if (c == '"' || c == '\\') { out += '\\'; out += c; }
    else if (c == '\n') out += "\\n";
    else out += c;
  }
  return out;
}

}  // namespace

extern "C" {

// Parse .lol text; returns a malloc'd JSON string: the scene on success,
// {"error": "...", "line": N} on failure. Free with lol_free.
const char* lol_parse(const char* text) {
  std::string out;
  try {
    Parser p(tokenize(text));
    out = to_json(p.parse());
  } catch (const ParseError& e) {
    out = "{\"error\":\"" + escape(e.message) +
          "\",\"line\":" + std::to_string(e.line) + "}";
  } catch (const std::exception& e) {
    out = "{\"error\":\"" + escape(e.what()) + "\",\"line\":0}";
  }
  char* buf = (char*)malloc(out.size() + 1);
  memcpy(buf, out.c_str(), out.size() + 1);
  return buf;
}

void lol_free(const char* p) { free((void*)p); }

}  // extern "C"
