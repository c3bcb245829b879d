"""Auth — a copy of ``sentio_tpu/infra/auth.py``: JWT access and refresh
tokens, API keys, sessions, roles and scopes, the password policy with a
lockout after failed logins, and the security-event audit log, on the
standard library's ``hmac`` and ``hashlib`` (HS256 JWTs with unpadded
base64url parts, PBKDF2-SHA256 password hashes), so a token or a hash made
by either package verifies in the other.

Scopes ``read``, ``write``, ``admin``, ``embed``, ``chat``, ``delete`` and
``metrics`` map onto the roles ``admin``, ``service``, ``user`` and
``readonly``.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import logging
import secrets
import threading
import time
from dataclasses import dataclass
from typing import Any, Optional

from sentio_tpu_torch.config import AuthConfig
from sentio_tpu_torch.infra.exceptions import AuthError, ErrorCode, ForbiddenError

logger = logging.getLogger(__name__)
audit_logger = logging.getLogger("sentio_tpu_torch.audit")

SCOPES = ("read", "write", "admin", "embed", "chat", "delete", "metrics")

ROLE_SCOPES: dict[str, tuple[str, ...]] = {
    "admin": SCOPES,
    "service": ("read", "write", "embed", "chat", "metrics"),
    "user": ("read", "chat", "embed"),
    "readonly": ("read",),
}


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode()


def _b64url_decode(text: str) -> bytes:
    pad = "=" * (-len(text) % 4)
    return base64.urlsafe_b64decode(text + pad)


def hash_password(password: str, salt: Optional[bytes] = None) -> str:
    salt = salt or secrets.token_bytes(16)
    digest = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 200_000)
    return f"pbkdf2${_b64url(salt)}${_b64url(digest)}"


def verify_password(password: str, stored: str) -> bool:
    try:
        _, salt_b64, digest_b64 = stored.split("$")
        salt = _b64url_decode(salt_b64)
        expected = _b64url_decode(digest_b64)
    except ValueError:
        return False
    candidate = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, 200_000)
    return hmac.compare_digest(candidate, expected)


class JWT:
    """Minimal HS256 JWT encode/verify (header.payload.signature)."""

    def __init__(self, secret: str) -> None:
        if not secret:
            raise ValueError("JWT secret must be non-empty")
        self._key = secret.encode()

    def encode(self, payload: dict[str, Any]) -> str:
        header = _b64url(json.dumps({"alg": "HS256", "typ": "JWT"}).encode())
        body = _b64url(json.dumps(payload, separators=(",", ":")).encode())
        signing_input = f"{header}.{body}".encode()
        sig = _b64url(hmac.new(self._key, signing_input, hashlib.sha256).digest())
        return f"{header}.{body}.{sig}"

    def decode(self, token: str) -> dict[str, Any]:
        try:
            header_b64, body_b64, sig_b64 = token.split(".")
        except ValueError as exc:
            raise AuthError("malformed token") from exc
        signing_input = f"{header_b64}.{body_b64}".encode()
        expected = hmac.new(self._key, signing_input, hashlib.sha256).digest()
        if not hmac.compare_digest(expected, _b64url_decode(sig_b64)):
            raise AuthError("invalid token signature")
        try:
            header = json.loads(_b64url_decode(header_b64))
            payload = json.loads(_b64url_decode(body_b64))
        except (ValueError, json.JSONDecodeError) as exc:
            raise AuthError("malformed token payload") from exc
        if header.get("alg") != "HS256":
            raise AuthError("unsupported token algorithm")
        exp = payload.get("exp")
        if exp is not None and time.time() > float(exp):  # wall-clock: JWT exp is epoch
            raise AuthError("token expired", code=ErrorCode.TOKEN_EXPIRED)
        return payload


@dataclass
class User:
    username: str
    password_hash: str
    role: str = "user"
    disabled: bool = False
    failed_attempts: int = 0
    locked_until: float = 0.0


@dataclass
class Session:
    session_id: str
    username: str
    created_at: float
    last_seen: float


class AuthManager:
    def __init__(self, config: Optional[AuthConfig] = None) -> None:
        self.config = config or AuthConfig()
        secret = self.config.jwt_secret or secrets.token_urlsafe(32)
        self.jwt = JWT(secret)
        self._users: dict[str, User] = {}
        self._api_keys: dict[str, str] = {}  # key-hash -> username
        self._sessions: dict[str, Session] = {}
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ users

    def create_user(self, username: str, password: str, role: str = "user") -> User:
        self._check_password_policy(password)
        if role not in ROLE_SCOPES:
            raise ValueError(f"unknown role {role!r}")
        with self._lock:
            if username in self._users:
                raise ValueError(f"user {username!r} exists")
            user = User(username=username, password_hash=hash_password(password), role=role)
            self._users[username] = user
        self.log_security_event("user_created", username=username, role=role)
        return user

    def _check_password_policy(self, password: str) -> None:
        if len(password) < self.config.min_password_len:
            raise ValueError(f"password must be >= {self.config.min_password_len} chars")
        checks = [
            any(c.islower() for c in password),
            any(c.isupper() for c in password),
            any(c.isdigit() for c in password),
        ]
        if not all(checks):
            raise ValueError("password needs lower, upper, and digit characters")

    def authenticate(self, username: str, password: str) -> dict[str, str]:
        with self._lock:
            user = self._users.get(username)
        if user is None or user.disabled:
            self.log_security_event("login_failed", username=username, reason="unknown/disabled")
            raise AuthError("invalid credentials")
        now = time.time()  # wall-clock: lockout epoch, seconds granularity
        if user.locked_until > now:
            self.log_security_event("login_locked", username=username)
            raise AuthError("account locked", code=ErrorCode.ACCOUNT_LOCKED)
        if not verify_password(password, user.password_hash):
            with self._lock:
                user.failed_attempts += 1
                if user.failed_attempts >= self.config.max_failed_attempts:
                    user.locked_until = now + self.config.lockout_s
                    user.failed_attempts = 0
                    self.log_security_event("account_locked", username=username)
            raise AuthError("invalid credentials")
        with self._lock:
            user.failed_attempts = 0
        self.log_security_event("login_ok", username=username)
        return self.issue_tokens(user)

    # ----------------------------------------------------------------- tokens

    def issue_tokens(self, user: User) -> dict[str, str]:
        now = time.time()  # wall-clock: JWT iat/exp are epoch
        base = {"sub": user.username, "role": user.role, "scopes": list(ROLE_SCOPES[user.role])}
        access = self.jwt.encode({**base, "type": "access", "iat": now,
                                  "exp": now + self.config.access_ttl_s})
        refresh = self.jwt.encode({"sub": user.username, "type": "refresh", "iat": now,
                                   "exp": now + self.config.refresh_ttl_s})
        return {"access_token": access, "refresh_token": refresh, "token_type": "bearer"}

    def refresh(self, refresh_token: str) -> dict[str, str]:
        payload = self.jwt.decode(refresh_token)
        if payload.get("type") != "refresh":
            raise AuthError("not a refresh token")
        with self._lock:
            user = self._users.get(payload.get("sub", ""))
        if user is None or user.disabled:
            raise AuthError("unknown user")
        return self.issue_tokens(user)

    def verify_token(self, token: str) -> dict[str, Any]:
        payload = self.jwt.decode(token)
        if payload.get("type") != "access":
            raise AuthError("not an access token")
        return payload

    # --------------------------------------------------------------- API keys

    def create_api_key(self, username: str) -> str:
        key = f"stk_{secrets.token_urlsafe(32)}"
        digest = hashlib.sha256(key.encode()).hexdigest()
        with self._lock:
            self._api_keys[digest] = username
        self.log_security_event("api_key_created", username=username)
        return key

    def verify_api_key(self, key: str) -> dict[str, Any]:
        digest = hashlib.sha256(key.encode()).hexdigest()
        with self._lock:
            username = self._api_keys.get(digest)
            user = self._users.get(username) if username else None
        if user is None or user.disabled:
            raise AuthError("invalid API key")
        return {"sub": user.username, "role": user.role, "scopes": list(ROLE_SCOPES[user.role])}

    def revoke_api_key(self, key: str) -> bool:
        digest = hashlib.sha256(key.encode()).hexdigest()
        with self._lock:
            return self._api_keys.pop(digest, None) is not None

    # ---------------------------------------------------------------- sessions

    def create_session(self, username: str) -> Session:
        session = Session(
            session_id=secrets.token_urlsafe(24),
            username=username,
            created_at=time.time(),  # wall-clock: session metadata is user-visible
            last_seen=time.time(),  # wall-clock: session metadata is user-visible
        )
        with self._lock:
            self._sessions[session.session_id] = session
        return session

    def get_session(self, session_id: str) -> Optional[Session]:
        with self._lock:
            session = self._sessions.get(session_id)
            if session is not None:
                session.last_seen = time.time()  # wall-clock: session metadata is user-visible
            return session

    def end_session(self, session_id: str) -> bool:
        with self._lock:
            return self._sessions.pop(session_id, None) is not None

    # -------------------------------------------------------------------- rbac

    @staticmethod
    def require_scopes(payload: dict[str, Any], *needed: str) -> None:
        have = set(payload.get("scopes", []))
        missing = [s for s in needed if s not in have]
        if missing:
            raise ForbiddenError(f"missing scopes: {missing}")

    @staticmethod
    def require_role(payload: dict[str, Any], *roles: str) -> None:
        if payload.get("role") not in roles:
            raise ForbiddenError(f"requires role in {roles}")

    # -------------------------------------------------------------------- audit

    @staticmethod
    def log_security_event(event: str, **fields: Any) -> None:
        audit_logger.info(json.dumps({"event": event, "at": time.time(), **fields}))  # wall-clock: audit log epoch
