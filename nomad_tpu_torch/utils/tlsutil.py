"""Mutual-TLS helpers for the RPC and HTTP planes.

Reference: helper/tlsutil/config.go (IncomingTLSConfig /
OutgoingTLSConfig — both planes wrap every listener and dial in
cert-verified TLS against a private CA) and the `nomad tls ca|cert
create` workflow (command/tls_ca_create.go) that mints the CA and
per-role certificates operators deploy.

Design: a single `TLSConfig` names the CA bundle and this node's cert/
key.  `server_context` REQUIRES a client certificate signed by the CA
(mutual TLS — an uncertified client cannot even complete the
handshake); `client_context` verifies the server against the same CA.
Hostname checks are disabled in favor of CA pinning: certs are minted
by this framework's own CA with role names (server.<region>.nomad), and
cluster addresses are dynamic IPs (the reference's VerifyServerHostname
mode maps to `verify_hostname`, checked against the role name via SAN).

The counterpart of `nomad_tpu.utils.tlsutil`.  Only the minting
functions (`generate_ca`, `generate_cert`, `write_pki`) need the
`cryptography` package, and they import it when called: the contexts
and `peer_role` are the standard library's `ssl`, so the RPC layer runs
where `cryptography` is missing.
"""
from __future__ import annotations

import datetime
import ipaddress
import os
import ssl
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple


@dataclass
class TLSConfig:
    """File-based TLS material (reference: config.TLSConfig)."""
    ca_file: str = ""
    cert_file: str = ""
    key_file: str = ""
    #: verify the presented server cert's SAN role name on outgoing
    #: connections (reference: VerifyServerHostname)
    verify_hostname: str = ""

    def enabled(self) -> bool:
        return bool(self.ca_file and self.cert_file and self.key_file)


def write_private(path: str, data: bytes) -> None:
    """Create a secrets file 0600 FROM BIRTH (no chmod-after-write
    window where another local user could read the key)."""
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o600)
    with os.fdopen(fd, "wb") as f:
        f.write(data)


def server_context(cfg: TLSConfig) -> ssl.SSLContext:
    """Incoming: mutual TLS — clients MUST present a CA-signed cert
    (reference: tlsutil IncomingTLSConfig with VerifyIncoming)."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    ctx.load_verify_locations(cfg.ca_file)
    ctx.verify_mode = ssl.CERT_REQUIRED
    return ctx


def client_context(cfg: TLSConfig) -> ssl.SSLContext:
    """Outgoing: present our cert, verify the peer against the CA."""
    ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_CLIENT)
    ctx.minimum_version = ssl.TLSVersion.TLSv1_2
    ctx.load_cert_chain(cfg.cert_file, cfg.key_file)
    ctx.load_verify_locations(cfg.ca_file)
    ctx.verify_mode = ssl.CERT_REQUIRED
    # CA pinning, not public-PKI hostname matching (cluster addresses
    # are dynamic); the role-name SAN check is applied post-handshake
    # by callers that set verify_hostname
    ctx.check_hostname = False
    return ctx


# ------------------------------------------------------------------ PKI
def generate_ca(common_name: str = "nomad-tpu-ca",
                days: int = 3650) -> Tuple[bytes, bytes]:
    """Mint a self-signed CA; returns (cert_pem, key_pem).
    Reference workflow: `nomad tls ca create`."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import NameOID

    key = ec.generate_private_key(ec.SECP256R1())
    name = x509.Name([x509.NameAttribute(NameOID.COMMON_NAME,
                                         common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.BasicConstraints(ca=True,
                                                 path_length=0),
                           critical=True)
            .add_extension(x509.KeyUsage(
                digital_signature=True, key_cert_sign=True,
                crl_sign=True, content_commitment=False,
                key_encipherment=False, data_encipherment=False,
                key_agreement=False, encipher_only=False,
                decipher_only=False), critical=True)
            .sign(key, hashes.SHA256()))
    return (cert.public_bytes(serialization.Encoding.PEM),
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))


def generate_cert(ca_cert_pem: bytes, ca_key_pem: bytes, role: str,
                  sans: Sequence[str] = ("localhost",),
                  ips: Sequence[str] = ("127.0.0.1",),
                  days: int = 365) -> Tuple[bytes, bytes]:
    """Mint a CA-signed leaf cert for `role` (e.g.
    "server.global.nomad" / "client.global.nomad" / "cli.global.nomad"
    — the reference's role naming).  Returns (cert_pem, key_pem)."""
    from cryptography import x509
    from cryptography.hazmat.primitives import hashes, serialization
    from cryptography.hazmat.primitives.asymmetric import ec
    from cryptography.x509.oid import ExtendedKeyUsageOID, NameOID

    ca_cert = x509.load_pem_x509_certificate(ca_cert_pem)
    ca_key = serialization.load_pem_private_key(ca_key_pem, None)
    key = ec.generate_private_key(ec.SECP256R1())
    now = datetime.datetime.now(datetime.timezone.utc)
    alt = [x509.DNSName(role)]
    alt += [x509.DNSName(s) for s in sans]
    alt += [x509.IPAddress(ipaddress.ip_address(i)) for i in ips]
    cert = (x509.CertificateBuilder()
            .subject_name(x509.Name(
                [x509.NameAttribute(NameOID.COMMON_NAME, role)]))
            .issuer_name(ca_cert.subject)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(days=days))
            .add_extension(x509.SubjectAlternativeName(alt),
                           critical=False)
            .add_extension(x509.ExtendedKeyUsage(
                [ExtendedKeyUsageOID.SERVER_AUTH,
                 ExtendedKeyUsageOID.CLIENT_AUTH]), critical=False)
            .sign(ca_key, hashes.SHA256()))
    return (cert.public_bytes(serialization.Encoding.PEM),
            key.private_bytes(
                serialization.Encoding.PEM,
                serialization.PrivateFormat.PKCS8,
                serialization.NoEncryption()))


def write_pki(directory: str, roles: Sequence[str] = (
        "server.global.nomad", "client.global.nomad",
        "cli.global.nomad")) -> dict:
    """Mint a CA + one cert per role into `directory`; returns
    {role: TLSConfig} plus "ca"/"ca_key" paths.  The test/dev analog of
    running `nomad tls ca create` + `nomad tls cert create` per role."""
    os.makedirs(directory, exist_ok=True)
    ca_pem, ca_key = generate_ca()
    ca_path = os.path.join(directory, "ca.pem")
    ca_key_path = os.path.join(directory, "ca-key.pem")
    with open(ca_path, "wb") as f:
        f.write(ca_pem)
    write_private(ca_key_path, ca_key)
    out = {"ca": ca_path, "ca_key": ca_key_path}
    for role in roles:
        cert, key = generate_cert(ca_pem, ca_key, role)
        cpath = os.path.join(directory, f"{role}.pem")
        kpath = os.path.join(directory, f"{role}-key.pem")
        with open(cpath, "wb") as f:
            f.write(cert)
        write_private(kpath, key)
        out[role] = TLSConfig(ca_file=ca_path, cert_file=cpath,
                              key_file=kpath)
    return out


def peer_role(sslobj) -> Optional[str]:
    """The role name (first DNS SAN) of a handshaked peer, for
    role-gated endpoints (reference: rpc.go verifies server.<region>
    on server-to-server conns)."""
    cert = sslobj.getpeercert()
    if not cert:
        return None
    for typ, val in cert.get("subjectAltName", ()):
        if typ == "DNS":
            return val
    return None
