"""The port's auth and security modules (``infra/auth.py``,
``infra/security.py``) against JAX's, on the same inputs.

* JWTs: a token made by either package with one secret is byte-equal to
  the other's and verifies in it; tampered, expired, malformed and
  wrong-algorithm tokens fail with the same code and message.
* Passwords: a hash made by either package verifies in the other, and
  with one salt the two hashes are equal.
* ``AuthManager``: one script of user creation, logins (the lockout after
  failed attempts included), token issue, refresh, API keys, sessions and
  the role / scope checks runs on both packages under one clock and one
  random source, and every outcome, token and audit event is equal.
* Security: ``sanitize_text`` and the root-logger filter, ``InputValidator``,
  ``TokenGenerator`` and ``CSRFProtection`` on tables of inputs."""

import hashlib
import hmac
import json
import logging
import re
import secrets

import pytest

from sentio_tpu.config import AuthConfig as JAuthConfig
from sentio_tpu.infra import auth as jauth
from sentio_tpu.infra import exceptions as jexc
from sentio_tpu.infra import security as jsec
from sentio_tpu_torch.config import AuthConfig
from sentio_tpu_torch.infra import auth as tauth
from sentio_tpu_torch.infra import exceptions as texc
from sentio_tpu_torch.infra import security as tsec

SECRET = "s3cret-key-for-tests"
NOW = 1_800_000_000.0


@pytest.fixture
def clock(monkeypatch):
    """``time.time`` for both packages, settable; ``secrets.token_urlsafe``
    as a counter, so keys and sessions are equal across packages."""
    state = {"now": NOW, "n": 0}
    monkeypatch.setattr("time.time", lambda: state["now"])

    def token_urlsafe(n=32):
        state["n"] += 1
        return f"tok{state['n']:04d}".ljust(n, "x")

    monkeypatch.setattr(secrets, "token_urlsafe", token_urlsafe)
    return state


def _outcome(fn, *args):
    """(``ok``, value) or (error class name, code, message)."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 — the outcome is compared
        return (type(exc).__name__, getattr(getattr(exc, "code", None), "value", None),
                str(exc))


PAYLOADS = [{"sub": "ada", "role": "user", "scopes": ["read", "chat"], "type": "access"},
            {"sub": "bob", "type": "refresh", "iat": NOW, "exp": NOW + 60},
            {"sub": "ünïcode", "n": 3, "nested": {"a": [1, 2.5, None]}}]


@pytest.mark.parametrize("payload", PAYLOADS, ids=["access", "refresh", "unicode"])
def test_jwt_is_byte_equal_and_verifies_across(clock, payload):
    tok, jtok = tauth.JWT(SECRET).encode(payload), jauth.JWT(SECRET).encode(payload)
    assert tok == jtok
    assert tauth.JWT(SECRET).decode(jtok) == jauth.JWT(SECRET).decode(tok) == payload
    assert "=" not in tok  # unpadded base64url


def _tampered(tok):
    head, body, sig = tok.split(".")
    return f"{head}.{body}.{sig[:-2]}AA"


def _resigned(tok, header):
    """``tok``'s body under another header, signed with the right secret."""
    head = jauth._b64url(json.dumps(header).encode())
    signing = f"{head}.{tok.split('.')[1]}".encode()
    return f"{head}.{tok.split('.')[1]}." + jauth._b64url(
        hmac.new(SECRET.encode(), signing, hashlib.sha256).digest())


BAD_TOKENS = {
    "tampered": _tampered,
    "malformed": lambda t: "not-a-token",
    "two_parts": lambda t: ".".join(t.split(".")[:2]),
    "other_secret": lambda t: jauth.JWT("other").encode({"sub": "x"}),
    "none_alg": lambda t: _resigned(t, {"alg": "none"}),
    "expired": lambda t: jauth.JWT(SECRET).encode({"sub": "x", "exp": NOW - 1}),
}


@pytest.mark.parametrize("case", sorted(BAD_TOKENS))
def test_bad_tokens_fail_alike(clock, case):
    tok = BAD_TOKENS[case](jauth.JWT(SECRET).encode(PAYLOADS[0]))
    got, want = _outcome(tauth.JWT(SECRET).decode, tok), _outcome(jauth.JWT(SECRET).decode, tok)
    assert got == want and got[0] == "AuthError"


def test_empty_secret_is_refused_alike():
    assert _outcome(tauth.JWT, "") == _outcome(jauth.JWT, "")


@pytest.mark.parametrize("password", ["Correct-Horse-9", "ünïcode Pässwörd 1", ""])
def test_password_hashes_cross_verify(password):
    salt = bytes(range(16))
    assert tauth.hash_password(password, salt) == jauth.hash_password(password, salt)
    jhash, thash = jauth.hash_password(password), tauth.hash_password(password)
    assert tauth.verify_password(password, jhash) and jauth.verify_password(password, thash)
    assert not tauth.verify_password(password + "x", jhash)
    assert tauth.verify_password(password, "garbage") is jauth.verify_password(password,
                                                                               "garbage")


def _script(mod, cfg, clock, caplog, audit_name):
    """One script of every AuthManager surface; returns each step's
    outcome and the audit events."""
    caplog.clear()
    clock.update(now=NOW, n=0)
    m = mod.AuthManager(cfg)
    out = []
    step = lambda name, fn, *a: out.append((name, _outcome(fn, *a)))  # noqa: E731
    step("weak", m.create_user, "ada", "short")
    step("no_digit", m.create_user, "ada", "NoDigitsHereAtAll")
    step("bad_role", m.create_user, "ada", "Str0ngPassword!", "emperor")
    step("create", lambda: m.create_user("ada", "Str0ngPassword!").role)
    step("create_admin", lambda: m.create_user("root", "Adm1nPassword!!", "admin").role)
    step("dup", m.create_user, "ada", "Str0ngPassword!")
    step("unknown", m.authenticate, "nobody", "x")
    tokens = m.authenticate("ada", "Str0ngPassword!")
    out.append(("login", tokens))
    step("verify", m.verify_token, tokens["access_token"])
    step("verify_refresh_as_access", m.verify_token, tokens["refresh_token"])
    step("refresh_access_as_refresh", m.refresh, tokens["access_token"])
    clock["now"] += 10
    step("refresh", m.refresh, tokens["refresh_token"])
    for i in range(cfg.max_failed_attempts):
        step(f"wrong_{i}", m.authenticate, "ada", "Wrong-Password-1")
    step("locked", m.authenticate, "ada", "Str0ngPassword!")
    clock["now"] += cfg.lockout_s + 1
    step("unlocked", lambda: sorted(m.authenticate("ada", "Str0ngPassword!")))
    clock["now"] += cfg.access_ttl_s + 1
    step("expired", m.verify_token, tokens["access_token"])
    key = m.create_api_key("root")
    out.append(("api_key", key))
    step("verify_key", m.verify_api_key, key)
    step("bad_key", m.verify_api_key, "stk_nope")
    step("revoke", m.revoke_api_key, key)
    step("revoked", m.verify_api_key, key)
    session = m.create_session("ada")
    out.append(("session", session.session_id, session.created_at))
    clock["now"] += 5
    step("get_session", lambda: m.get_session(session.session_id).last_seen)
    step("end_session", m.end_session, session.session_id)
    step("gone_session", m.get_session, session.session_id)
    user = {"sub": "ada", "role": "user", "scopes": list(mod.ROLE_SCOPES["user"])}
    step("scopes_ok", m.require_scopes, user, "read", "chat")
    step("scopes_missing", m.require_scopes, user, "admin", "delete")
    step("role_ok", m.require_role, user, "user", "admin")
    step("role_missing", m.require_role, user, "admin")
    events = [json.loads(r.getMessage()) for r in caplog.records if r.name == audit_name]
    return out, events


def test_auth_manager_script_matches_jax(clock, caplog):
    caplog.set_level(logging.INFO)
    kw = dict(jwt_secret=SECRET, max_failed_attempts=3, lockout_s=60, access_ttl_s=120)
    got = _script(tauth, AuthConfig(**kw), clock, caplog, "sentio_tpu_torch.audit")
    want = _script(jauth, JAuthConfig(**kw), clock, caplog, "sentio_tpu.audit")
    assert got == want
    steps = {s[0]: s[1] for s in got[0]}
    assert steps["locked"][1] == "ACCOUNT_LOCKED" and steps["expired"][1] == "TOKEN_EXPIRED"
    assert [e["event"] for e in got[1]].count("login_failed") == 1


def test_auth_config_reads_jax_env_names(monkeypatch):
    for name, value in (("AUTH_ENABLED", "1"), ("JWT_SECRET_KEY", "k"), ("JWT_ACCESS_TTL", "7"),
                        ("JWT_REFRESH_TTL", "8"), ("AUTH_MAX_FAILED", "2"),
                        ("AUTH_LOCKOUT_S", "9"), ("AUTH_MIN_PASSWORD_LEN", "4")):
        monkeypatch.setenv(name, value)
    assert vars(AuthConfig.from_env()) == vars(JAuthConfig.from_env())
    monkeypatch.setenv("JWT_SECRET", "first")
    assert AuthConfig.from_env().jwt_secret == JAuthConfig.from_env().jwt_secret == "first"


@pytest.mark.parametrize("name", ["AuthError", "ForbiddenError", "CircuitOpenError",
                                  "TimeoutError_"])
def test_new_error_types_map_as_jax(name):
    exc, jexc_ = getattr(texc, name)("m"), getattr(jexc, name)("m")
    assert (exc.status, exc.code.value) == (jexc_.status, jexc_.code.value)


# ------------------------------------------------------------------ security

TEXTS = ["api_key=abc123 rest", "Authorization: Bearer xyz.abc", 'password: "hunter2";',
         "token='t0k3n'", "key stk_" + "A" * 24 + " end", "jwt eyJhbGc.eyJzdWIi.c2ln done",
         "nothing secret here", "SECRET = plain&more", ""]


@pytest.mark.parametrize("text", TEXTS)
def test_sanitize_text_matches_jax(text):
    assert tsec.sanitize_text(text) == jsec.sanitize_text(text)


def test_log_sanitizer_redacts_records_and_installs_once(monkeypatch):
    record = logging.LogRecord("x", logging.INFO, __file__, 1, "login %s token=%s", ("ada", "t1"),
                               None)
    jrecord = logging.LogRecord("x", logging.INFO, __file__, 1, "login %s token=%s",
                                ("ada", "t1"), None)
    assert tsec.LogSanitizer().filter(record) and jsec.LogSanitizer().filter(jrecord)
    assert (record.msg, record.args) == (jrecord.msg, jrecord.args) == \
        ("login ada token=[REDACTED]", ())
    root = logging.getLogger()
    monkeypatch.setattr(tsec, "_sanitizer_installed", False)
    before = list(root.filters)
    try:
        tsec.setup_log_sanitization()
        tsec.setup_log_sanitization()
        added = [f for f in root.filters if f not in before]
        assert len(added) == 1 and isinstance(added[0], tsec.LogSanitizer)
    finally:
        for f in [f for f in root.filters if f not in before]:
            root.removeFilter(f)
        for handler in root.handlers:
            for f in [f for f in handler.filters if isinstance(f, tsec.LogSanitizer)]:
                handler.removeFilter(f)


VALIDATE = [
    ("validate_query", "  what is up?\x00 "), ("validate_query", ""), ("validate_query", 7),
    ("validate_query", "x" * 2001), ("validate_query", "<script>alert(1)</script>"),
    ("validate_query", "1 UNION SELECT *"), ("validate_content", "body\x07 text"),
    ("validate_content", "   "), ("validate_content", None), ("validate_content", "x" * 50_001),
    ("validate_metadata", None), ("validate_metadata", []), ("validate_metadata", {"a": 1}),
    ("validate_metadata", {"a": "b\x01c", "n": None, "f": 1.5}),
    ("validate_metadata", {str(i): i for i in range(65)}), ("validate_metadata", {"k" * 129: 1}),
    ("validate_metadata", {"a": "x" * 4097}), ("validate_metadata", {"a": [1]}),
    ("sanitize_html", "<b>\"a\" & 'b'</b>"),
]


@pytest.mark.parametrize("method,value", VALIDATE, ids=lambda v: repr(v)[:24])
def test_input_validator_matches_jax(method, value):
    got = _outcome(getattr(tsec.InputValidator(), method), value)
    want = _outcome(getattr(jsec.InputValidator(), method), value)
    assert got == want


def test_token_generator_and_csrf_match_jax(monkeypatch):
    assert re.fullmatch(r"[A-Za-z0-9_-]{43}", tsec.TokenGenerator.token())
    assert re.fullmatch(r"[0-9]{8}", tsec.TokenGenerator.numeric_code(8))
    monkeypatch.setattr("time.time", lambda: NOW)
    tok = tsec.CSRFProtection("k").issue("session-1")
    assert tok == jsec.CSRFProtection("k").issue("session-1")
    assert jsec.CSRFProtection("k").verify("session-1", tok)
    for session, token, age in (("session-1", tok, 3600.0), ("session-2", tok, 3600.0),
                                ("session-1", "garbage", 3600.0), ("session-1", tok, -1.0)):
        assert tsec.CSRFProtection("k").verify(session, token, age) == \
            jsec.CSRFProtection("k").verify(session, token, age)
