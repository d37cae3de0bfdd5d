# Copied from gatekeeper_tpu/webhook/certs.py; only comments differ: the
# openssl fallback's note names no particular image. Both generators stay:
# `cryptography` where it is installed, the `openssl` binary where not.
"""Webhook TLS: self-signed CA + server certificate with rotation.

Behavioral mirror of pkg/webhook/certs.go:
  * a self-signed CA valid 10 years (createCACert, certs.go:265-301)
    signs a server certificate valid 1 year (createCertPEM,
    certs.go:303-344);
  * certificates are refreshed when missing, invalid, or within the
    90-day rotation lookahead of expiry (refreshCertIfNeeded +
    lookaheadInterval, certs.go:119-181,346);
  * artifacts live in a directory as ca.crt / tls.crt / tls.key (the
    reference stores them in a Secret mounted at certDir); serving
    blocks until they exist (main.go:154-172's CertsMounted gate is the
    `ensure()` call here).

The CA bundle injection into a ValidatingWebhookConfiguration
(certs.go:183-263) maps to `ca_bundle()` — the control plane hands it
to whatever registers the webhook.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
import threading
from typing import Optional, Tuple

CA_VALIDITY_DAYS = 3650  # 10 years (certs.go:269)
CERT_VALIDITY_DAYS = 365  # 1 year (certs.go:307)
LOOKAHEAD_DAYS = 90  # rotation lookahead (certs.go:346)

CA_NAME = "gatekeeper-ca"


def _now() -> datetime.datetime:
    return datetime.datetime.now(datetime.timezone.utc)


class CertRotator:
    """Generates and rotates the CA + server cert pair on disk."""

    def __init__(
        self,
        cert_dir: str,
        dns_name: str = "localhost",
        now=None,
    ):
        self.cert_dir = cert_dir
        self.dns_name = dns_name
        self._now = now if now is not None else _now
        self._lock = threading.Lock()
        self.rotations = 0

    # -- paths ---------------------------------------------------------------

    @property
    def ca_path(self) -> str:
        return os.path.join(self.cert_dir, "ca.crt")

    @property
    def cert_path(self) -> str:
        return os.path.join(self.cert_dir, "tls.crt")

    @property
    def key_path(self) -> str:
        return os.path.join(self.cert_dir, "tls.key")

    # -- public --------------------------------------------------------------

    def ensure(self) -> Tuple[str, str]:
        """Refresh-if-needed; returns (cert_path, key_path). The serving
        layer calls this before binding TLS (the CertsMounted gate)."""
        with self._lock:
            if self._needs_refresh():
                self._refresh()
        return self.cert_path, self.key_path

    def ca_bundle(self) -> bytes:
        self.ensure()
        with open(self.ca_path, "rb") as f:
            return f.read()

    # -- internals -----------------------------------------------------------

    def _needs_refresh(self) -> bool:
        for p in (self.ca_path, self.cert_path, self.key_path):
            if not os.path.exists(p):
                return True
        exp = self._cert_expiry(self.cert_path)
        if exp is None:
            return True
        lookahead = self._now() + datetime.timedelta(days=LOOKAHEAD_DAYS)
        return exp <= lookahead

    @staticmethod
    def pem_expiry(data: bytes) -> Optional[datetime.datetime]:
        """not_valid_after of the first certificate in a PEM blob, or
        None when unparseable (treated as needs-refresh). Prefers the
        `cryptography` package; images without it fall back to the `openssl` binary."""
        try:
            from cryptography import x509

            cert = x509.load_pem_x509_certificate(data)
            return cert.not_valid_after_utc
        except ImportError:
            return _openssl_expiry(data)
        except Exception:
            return None

    @classmethod
    def _cert_expiry(cls, path: str) -> Optional[datetime.datetime]:
        try:
            with open(path, "rb") as f:
                return cls.pem_expiry(f.read())
        except Exception:
            return None

    def _refresh(self) -> None:
        self.install_artifacts(self.generate_pair())
        self.rotations += 1

    def generate_pair(self) -> dict:
        """Generate a fresh CA + server pair; returns the PEM artifacts
        as {"ca.crt": bytes, "tls.crt": bytes, "tls.key": bytes} WITHOUT
        touching disk — the fleet cert store offers this dict to the
        shared Secret before any replica serves it. Prefers the
        `cryptography` package; falls back to the `openssl` binary so
        TLS serving works in containers without the wheel."""
        try:
            from cryptography import x509  # noqa: F401
        except ImportError:
            return _openssl_generate_pair(self.dns_name)
        return self._generate_pair_cryptography()

    def _generate_pair_cryptography(self) -> dict:
        from cryptography import x509
        from cryptography.hazmat.primitives import hashes, serialization
        from cryptography.hazmat.primitives.asymmetric import rsa
        from cryptography.x509.oid import NameOID

        now = self._now()

        # CA (certs.go:265-301)
        ca_key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
        ca_name = x509.Name(
            [x509.NameAttribute(NameOID.COMMON_NAME, CA_NAME)]
        )
        ca_cert = (
            x509.CertificateBuilder()
            .subject_name(ca_name)
            .issuer_name(ca_name)
            .public_key(ca_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=CA_VALIDITY_DAYS))
            .add_extension(
                x509.BasicConstraints(ca=True, path_length=None),
                critical=True,
            )
            .add_extension(
                x509.KeyUsage(
                    digital_signature=True,
                    key_cert_sign=True,
                    crl_sign=True,
                    content_commitment=False,
                    key_encipherment=False,
                    data_encipherment=False,
                    key_agreement=False,
                    encipher_only=False,
                    decipher_only=False,
                ),
                critical=True,
            )
            .sign(ca_key, hashes.SHA256())
        )

        # server cert (certs.go:303-344)
        srv_key = rsa.generate_private_key(
            public_exponent=65537, key_size=2048
        )
        sans = [x509.DNSName(self.dns_name)]
        if self.dns_name != "localhost":
            sans.append(x509.DNSName("localhost"))
        sans.append(x509.IPAddress(ipaddress.ip_address("127.0.0.1")))
        srv_cert = (
            x509.CertificateBuilder()
            .subject_name(
                x509.Name(
                    [x509.NameAttribute(NameOID.COMMON_NAME, self.dns_name)]
                )
            )
            .issuer_name(ca_name)
            .public_key(srv_key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(
                now + datetime.timedelta(days=CERT_VALIDITY_DAYS)
            )
            .add_extension(
                x509.SubjectAlternativeName(sans), critical=False
            )
            .add_extension(
                x509.ExtendedKeyUsage(
                    [x509.oid.ExtendedKeyUsageOID.SERVER_AUTH]
                ),
                critical=False,
            )
            .sign(ca_key, hashes.SHA256())
        )

        pem = serialization.Encoding.PEM
        return {
            "ca.crt": ca_cert.public_bytes(pem),
            # chain the CA so clients can verify with just tls.crt
            "tls.crt": srv_cert.public_bytes(pem)
            + ca_cert.public_bytes(pem),
            "tls.key": srv_key.private_bytes(
                pem,
                serialization.PrivateFormat.TraditionalOpenSSL,
                serialization.NoEncryption(),
            ),
        }

    def install_artifacts(self, artifacts: dict) -> None:
        """Write the ca.crt / tls.crt / tls.key triple via
        write-then-atomic-rename. With multiple replicas two concurrent
        `ensure()` callers are real, and a reader racing an in-place
        rewrite could load a tls.crt signed by a ca.crt it hasn't seen —
        a torn pair. os.rename within one directory is atomic, so every
        reader sees either the old artifact or the new one, never a
        partial write; the key lands BEFORE the certs so no reader can
        observe a cert whose key is still the old one's."""
        os.makedirs(self.cert_dir, exist_ok=True)
        for fname, path, mode in (
            ("tls.key", self.key_path, 0o600),
            ("ca.crt", self.ca_path, None),
            ("tls.crt", self.cert_path, None),
        ):
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                f.write(artifacts[fname])
            if mode is not None:
                os.chmod(tmp, mode)
            os.rename(tmp, path)


# -- openssl-CLI fallback ----------------------------------------------------
# An image without the `cryptography` wheel must still serve TLS, so the
# same CA/server-pair semantics are reproduced with the `openssl` binary. Same validity windows, same SANs, same chained
# tls.crt output.


def _openssl_expiry(data: bytes) -> Optional[datetime.datetime]:
    import subprocess

    try:
        out = subprocess.run(
            ["openssl", "x509", "-noout", "-enddate"],
            input=data, capture_output=True, timeout=30, check=True,
        ).stdout.decode()
    except Exception:
        return None
    # "notAfter=Jan  1 12:00:00 2036 GMT"
    _, _, stamp = out.strip().partition("=")
    stamp = stamp.replace(" GMT", "").strip()
    try:
        dt = datetime.datetime.strptime(stamp, "%b %d %H:%M:%S %Y")
    except ValueError:
        return None
    return dt.replace(tzinfo=datetime.timezone.utc)


def _openssl_generate_pair(dns_name: str) -> dict:
    import subprocess
    import tempfile

    def run(*args, **kw):
        subprocess.run(
            list(args), capture_output=True, timeout=120, check=True, **kw
        )

    with tempfile.TemporaryDirectory(prefix="gk-certgen-") as d:
        ca_key, ca_crt = f"{d}/ca.key", f"{d}/ca.crt"
        srv_key, srv_csr, srv_crt = (
            f"{d}/tls.key", f"{d}/srv.csr", f"{d}/srv.crt"
        )
        # an explicit -config (not -addext): the system openssl.cnf adds
        # its own default basicConstraints, and a certificate with the
        # extension twice fails chain verification
        ca_cnf = f"{d}/ca.cnf"
        with open(ca_cnf, "w") as f:
            f.write(
                "[req]\n"
                "distinguished_name=dn\n"
                "x509_extensions=v3_ca\n"
                "prompt=no\n"
                f"[dn]\nCN={CA_NAME}\n"
                "[v3_ca]\n"
                "basicConstraints=critical,CA:TRUE\n"
                "keyUsage=critical,digitalSignature,keyCertSign,cRLSign\n"
                "subjectKeyIdentifier=hash\n"
            )
        run(
            "openssl", "req", "-x509", "-newkey", "rsa:2048", "-nodes",
            "-keyout", ca_key, "-out", ca_crt,
            "-days", str(CA_VALIDITY_DAYS), "-config", ca_cnf,
        )
        run(
            "openssl", "req", "-newkey", "rsa:2048", "-nodes",
            "-keyout", srv_key, "-out", srv_csr,
            "-subj", f"/CN={dns_name}",
        )
        sans = [f"DNS:{dns_name}"]
        if dns_name != "localhost":
            sans.append("DNS:localhost")
        sans.append("IP:127.0.0.1")
        ext = f"{d}/ext.cnf"
        with open(ext, "w") as f:
            f.write(
                f"subjectAltName={','.join(sans)}\n"
                "extendedKeyUsage=serverAuth\n"
            )
        run(
            "openssl", "x509", "-req", "-in", srv_csr,
            "-CA", ca_crt, "-CAkey", ca_key, "-CAcreateserial",
            "-days", str(CERT_VALIDITY_DAYS), "-out", srv_crt,
            "-extfile", ext,
        )

        def read(p: str) -> bytes:
            with open(p, "rb") as f:
                return f.read()

        ca_pem = read(ca_crt)
        return {
            "ca.crt": ca_pem,
            # chain the CA so clients can verify with just tls.crt
            "tls.crt": read(srv_crt) + ca_pem,
            "tls.key": read(srv_key),
        }


VWH_GVK_ARGS = ("admissionregistration.k8s.io", "v1",
                "ValidatingWebhookConfiguration")


class CaBundleInjector:
    """Injects the rotator's CA bundle into a
    ValidatingWebhookConfiguration and re-injects on drift — the
    reference's injectCertToWebhook + ReconcileVWH self-healing loop
    (certs.go:183-263,468-515), driven through the EventSource seam so
    it works against the FakeCluster and the real apiserver alike."""

    def __init__(self, cluster, rotator: "CertRotator", vwh_name: str):
        from ..control.events import GVK

        self.cluster = cluster
        self.rotator = rotator
        self.vwh_name = vwh_name
        self.gvk = GVK(*VWH_GVK_ARGS)
        self.injections = 0
        self._unsubscribe = None

    def start(self) -> None:
        self.inject()
        self._unsubscribe = self.cluster.subscribe(self.gvk, self._on_event)
        # fleet rotators announce rotations (their own AND peers' picked
        # up from the shared Secret): re-inject immediately instead of
        # waiting for VWH drift to be noticed
        on_rotate = getattr(self.rotator, "on_rotate", None)
        if on_rotate is not None:
            on_rotate(lambda *_a, **_k: self.inject())

    def stop(self) -> None:
        if self._unsubscribe is not None:
            self._unsubscribe()
            self._unsubscribe = None

    def _bundle_b64(self) -> str:
        import base64

        return base64.b64encode(self.rotator.ca_bundle()).decode()

    def _on_event(self, ev) -> None:
        meta = ev.obj.get("metadata") or {}
        if meta.get("name") != self.vwh_name or ev.type == "DELETED":
            return
        want = self._bundle_b64()
        hooks = ev.obj.get("webhooks") or []
        if any(
            (h.get("clientConfig") or {}).get("caBundle") != want
            for h in hooks
        ):
            self.inject()

    def inject(self) -> bool:
        obj = None
        getter = getattr(self.cluster, "get", None)
        if getter is not None:
            obj = getter(self.gvk, "", self.vwh_name)
        if obj is None:
            for cand in self.cluster.list(self.gvk):
                if (cand.get("metadata") or {}).get("name") == self.vwh_name:
                    obj = cand
                    break
        if obj is None:
            return False
        want = self._bundle_b64()
        changed = False
        hooks = obj.get("webhooks") or []
        for h in hooks:
            cc = h.setdefault("clientConfig", {})
            if cc.get("caBundle") != want:
                cc["caBundle"] = want
                changed = True
        if changed:
            self.cluster.apply(obj)
            self.injections += 1
        return changed
